"""Tile engine: bundle adjustment for ARBITRARY camera graphs.

This is the at-scale path for problems WITHOUT rig structure (BAL-style
scenes, the reference's non-shared mode: ``src/ParameterBlock.hh:52-55``
column semantics + ``src/sfm.cc:67`` DENSE_SCHUR over an arbitrary
camera-point bipartite graph). The dense-grid engine (rig_grid.py) requires
``share_extrinsic``; the observation-list engine (ba.py) is correct for any
graph but spends its time in gathers and segment-sums over the observation
list. The tile engine is laid out around dense reductions instead:

  * **Point-major dense rows.** The observations of one point form one
    padded row of W slots (W = next power of two >= track length; points
    are bucketed by W). Every per-point reduction (g_p, H_pp, the
    E-coupling products, back-substitution) is a dense within-row reduce,
    not a segment-sum. Points are permuted so buckets are contiguous
    slices: the point side needs zero gathers.
  * **Cell table.** The distinct (outer-extrinsic, inner-extrinsic,
    intrinsic) triples form V "cells" (== physical cameras for BAL). All
    per-slot camera parameters are packed into ONE (V, D) table; per-chunk
    lookups AND camera-side binning share a single exact one-hot matmul
    (a 0/1 one-hot at ``Precision.HIGHEST`` selects rows exactly; in TF32
    it would round them).
  * **Cell-space reduced camera system.** H_cc is kept as per-cell 18x18
    Grams (V, 18, 18); H_cc v, the Schur correction E^T B^-1 E v, the
    block-Jacobi preconditioner, and gradient binning all work in cell
    space and touch the flat C-vector only through tiny (V*18)-sized
    scatter-adds / gathers. The C x C matrix is never materialized, so
    camera count does not cap the engine.
  * **Fused matvec sweep.** One PCG application of S is ONE chunked sweep
    over observations (E v, B^-1, E^T all inside the chunk — B^-1 is
    row-local), not three.

The reduced system is solved matrix-free with PCG (ITERATIVE_SCHUR with
block-Jacobi, the Ceres SCHUR_JACOBI analogue); LM control flow follows the
same Ceres trust-region law as the other engines (``src/sfm.cc:66-73``
configuration). Parity with the indexed engine is asserted in
tests/test_tiles.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.scene import BAParams, Scene
from deeparc_tpu.solver import trust_region as tr_mod
from deeparc_tpu.solver.linalg import HIGHEST, inv3x3, pcg
from deeparc_tpu.solver.loss import rho as loss_rho, weight as loss_weight
from deeparc_tpu.solver.trust_region import lm_diagonal

# target observations per compiled chunk: rows-per-chunk = CHUNK_OBS // W,
# so narrow buckets take many rows per chunk and wide buckets few.
CHUNK_OBS = 8192


def rows_per_chunk(width: int, chunk_obs: int = CHUNK_OBS) -> int:
    return max(chunk_obs // width, 1)


class CellTable(NamedTuple):
    """Distinct camera-slot triples (the "virtual cameras" of the scene).

    Duck-typed to what ``rig_grid.slot_params`` needs, so the cell-level
    derived quantities (rotation matrices, right Jacobians, focal/distortion
    slots) come from the exact same code the grid engine uses.
    """

    slot_outer: jnp.ndarray    # (V,) int32 extrinsic row ids
    slot_inner: jnp.ndarray    # (V,)
    slot_intr: jnp.ndarray     # (V,)
    focal_shared: jnp.ndarray  # (V,)
    dist_m1: jnp.ndarray       # (V,)
    dist_m2: jnp.ndarray       # (V,)
    cols: jnp.ndarray          # (V, 18) flat camera-vector column ids


class TileBucket(NamedTuple):
    """Points whose (padded) track length is W, as dense (Nb, W) planes.

    ``loc`` is the optional locality blocking: when points are clustered so
    that each compiled chunk of B rows touches only V_local << V distinct
    cells, every cell-space lookup and binning in the sweeps becomes a
    SMALL (B*W, V_local) one-hot matmul against a per-chunk local table —
    O(V_local) instead of O(V) work per slot — plus a tiny
    per-chunk (V_local, .) gather/scatter against the global table. Real
    BAL camera graphs have strong co-visibility locality; without it
    (``loc == ()``) the engines fall back to the global-table path.
    """

    cell: jnp.ndarray  # (Nb, W) int32 GLOBAL cell id per slot (0 if masked)
    xy0: jnp.ndarray   # (Nb, W) observed pixel x
    xy1: jnp.ndarray   # (Nb, W)
    mask: jnp.ndarray  # (Nb, W) 1.0 = observed
    loc: tuple = ()    # () or (local (Nb, W) int32 in [0, V_local),
    #                           chunk_cells (n_chunks, V_local) int32 global
    #                           cell id per local slot; n_chunks = Nb // B)


def _locality_cell_order(cell_of_obs, pts_of_obs, V0, N):
    """Cell permutation for chunk locality: reverse Cuthill-McKee on the
    cell co-visibility graph, made robust to 'hub' cells (popular views
    co-visible with a large fraction of all cells — real photo
    collections have them, and they densify the graph enough to destroy
    RCM's bandwidth). Hubs are stripped before ordering and appended at
    the end; the exact per-chunk tables (bucket_with_local) absorb the few
    hub ids each chunk touches. Returns ``(perm, hub_mask_or_None)`` with
    perm mapping new rank -> old cell id.

    Reference bar: Ceres' evaluation cost is graph-shape independent
    (``src/sfm.cc:36-48``); this keeps the tile engine's chunk tables
    narrow whenever narrowness exists to find.
    """
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = _sp.coo_matrix(
        (np.ones(cell_of_obs.size, np.float32),
         (cell_of_obs, pts_of_obs)), shape=(V0, N)).tocsr()
    G = (A @ A.T).tocsr()
    deg = np.diff(G.indptr).astype(np.int64)
    med = max(float(np.median(deg)), 1.0)
    # a hub is co-visible with most of the graph AND well above typical:
    # uniformly dense graphs (rigs, random) have med ~ V and flag nothing
    hub_mask = deg > np.maximum(2.0 * med, 0.5 * V0)
    if hub_mask.any() and hub_mask.sum() < 0.2 * V0:
        keep = np.nonzero(~hub_mask)[0]
    else:
        keep = np.arange(V0)
        hub_mask = None
    Gs = G[keep][:, keep].tocsr()

    # candidate orders of the (stripped) graph: RCM, and the spectral
    # CYCLIC embedding (capture paths are often closed rings; BFS-based
    # RCM folds the cycle, doubling the band — the angle of the two
    # leading nontrivial eigenvectors recovers ring order, exactly as in
    # solver/rig_band._cell_orderings). Scored by p99 CYCLIC bandwidth
    # over co-visibility edges (the point keys downstream handle a
    # circular order).
    cands = [np.asarray(
        reverse_cuthill_mckee(Gs, symmetric_mode=True), np.int64)]
    k = keep.size
    if 4 <= k <= 4096:
        a = np.asarray(Gs.todense(), np.float64)
        d = np.maximum(a.sum(axis=1), 1e-9)
        a = a / np.sqrt(d[:, None] * d[None, :])
        try:
            _, vecs = np.linalg.eigh(a)
            cands.append(np.argsort(
                np.arctan2(vecs[:, -3], vecs[:, -2])).astype(np.int64))
        except np.linalg.LinAlgError:
            pass

    Gc = Gs.tocoo()
    nz = Gc.row != Gc.col

    def cyc_band(sub):
        rank = np.empty(k, np.int64)
        rank[sub] = np.arange(k)
        dd = np.abs(rank[Gc.row[nz]] - rank[Gc.col[nz]])
        dd = np.minimum(dd, k - dd)
        return float(np.percentile(dd, 99)) if dd.size else 0.0

    sub = min(cands, key=cyc_band)
    if hub_mask is not None:
        return (np.concatenate([keep[sub], np.nonzero(hub_mask)[0]]),
                hub_mask)
    return keep[sub], None


def _order_chunk_width(members_sorted, rpc, pts_of_obs, cell_of_obs,
                       sel_mask, N, V):
    """Max distinct cells any rpc-row chunk touches under this member
    order (the exact v_local the chunk tables would get, pre-pow2)."""
    if members_sorted.size == 0:
        return 0
    rank = np.full(N, -1, np.int64)
    rank[members_sorted] = np.arange(members_sorted.size)
    chunk = rank[pts_of_obs[sel_mask]] // rpc
    pairs = np.unique(chunk * np.int64(V) + cell_of_obs[sel_mask])
    return int(np.bincount(pairs // V).max())


def bucket_with_local(bucket: TileBucket, rows_chunk: int,
                      v_local_max: int | None = None,
                      min_v_local: int = 8) -> TileBucket:
    """Attach exact per-chunk local cell tables to a bucket (host-side).

    ``rows_chunk`` must be the B the step functions will use
    (``rows_per_chunk(W, chunk_obs)``). V_local = the per-bucket max of
    distinct cells in any chunk, rounded up to a power of two (>= 8). If
    that exceeds ``v_local_max`` (default: half the theoretical chunk-slot
    count — past which blocking stops paying) the bucket is returned
    unchanged and the engines use the global table.
    """
    cell = np.asarray(bucket.cell)
    Nb, W = cell.shape
    assert Nb % rows_chunk == 0, (Nb, rows_chunk)
    n_chunks = Nb // rows_chunk
    uniqs = [
        np.unique(cell[c * rows_chunk:(c + 1) * rows_chunk])
        for c in range(n_chunks)
    ]
    max_u = max((u.size for u in uniqs), default=1)
    v_local = max(min_v_local, 1 << (max_u - 1).bit_length())
    if v_local_max is None:
        v_local_max = max(rows_chunk * W // 2, min_v_local)
    if v_local > v_local_max:
        return bucket._replace(loc=())
    local = np.zeros((Nb, W), np.int32)
    chunk_cells = np.zeros((n_chunks, v_local), np.int32)
    for c, u in enumerate(uniqs):
        sl = slice(c * rows_chunk, (c + 1) * rows_chunk)
        chunk_cells[c, : u.size] = u
        local[sl] = np.searchsorted(u, cell[sl]).astype(np.int32)
    return bucket._replace(loc=(
        jnp.asarray(local), jnp.asarray(chunk_cells)))


class CamBucket(NamedTuple):
    """Cells whose (padded/split) slot count is S, as dense (R, S) rows.

    The camera-major dual of TileBucket: one row = the slots of ONE cell
    (large cells are split across several rows; rows are padded with the
    point-major sentinel index, which gathers zeros). Because every slot in
    a row shares a single cell, cell-space lookups are row broadcasts and
    cell-space binning is a within-row reduce — no one-hot matmuls.
    """

    row_cell: jnp.ndarray  # (R,) int32 cell id per row
    slot_idx: jnp.ndarray  # (R, S) int32 point-major flat slot index


class CamLayout(NamedTuple):
    buckets: tuple          # tuple[CamBucket, ...]
    pm_src: jnp.ndarray     # (M_flat,) int32: point-major slot -> cam-flat
    #                         position (or F = sentinel for dead slots)


class TileIndex(NamedTuple):
    cells: CellTable
    buckets: tuple                 # tuple[TileBucket, ...]
    row_of_point: jnp.ndarray      # (N_orig,) permuted+padded row per point
    cam: tuple = ()                # () or (CamLayout,) — camera-major dual
    #                                layout for impl='dual' (with_cam_layout)


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------


def tiles_from_scene(
    scene: Scene,
    free: BAParams | None = None,
    min_width: int = 4,
    chunk_obs: int = CHUNK_OBS,
    dtype=None,
    locality: bool = True,
    v_local_max: int | None = None,
    with_slot_src: bool = False,
):
    """Build the tile layout from any Scene (shared rig or BAL-style).

    Returns ``(tiles, params_t, free_points_t)`` where ``params_t.points``
    (and the point freeze mask) live in PERMUTED + PADDED row space: bucket
    b's rows are the contiguous slice following bucket b-1's, each bucket is
    padded to a multiple of its rows-per-chunk with dead rows (mask 0,
    point at (0,0,1)), and zero-track points sit in a tail slice. Use
    :func:`unpermute_points` to map results back.
    """
    dtype = dtype or scene.params.points.dtype
    idx = scene.index
    obs_point = np.asarray(idx.obs_point)
    obs_alive = (np.asarray(idx.obs_mask) > 0.5) & (
        np.asarray(idx.point_mask)[obs_point] > 0.5
    )
    outer = np.asarray(idx.obs_outer)[obs_alive]
    inner = np.asarray(idx.obs_inner)[obs_alive]
    intr = np.asarray(idx.obs_intr)[obs_alive]
    xy = np.asarray(idx.obs_xy)[obs_alive]
    pts_of_obs = obs_point[obs_alive]
    N = scene.n_points
    R_rows = scene.params.ext_rot.shape[0]

    # --- cells: unique (outer, inner, intr) triples -----------------------
    triples = np.stack([outer, inner, intr], axis=1)
    cells_np, cell_of_obs = np.unique(triples, axis=0, return_inverse=True)
    cell_of_obs = cell_of_obs.reshape(-1)
    # Renumber cells by reverse Cuthill-McKee on the cell co-visibility
    # graph: real BAL scenes have strong co-visibility locality but
    # ARBITRARY camera ids, so without this the per-chunk local tables
    # (TileBucket.loc — what keeps the one-hot sweeps narrow) would be
    # as wide as the whole camera list. RCM gives co-visible cells nearby
    # ids; combined with the mean-cell point ordering below, each chunk
    # then touches a narrow band of cells. Harmless when no locality
    # exists (rigs: the graph is near-complete and the order is moot).
    hub_cell = None
    if locality and cells_np.shape[0] > 2:
        V0 = cells_np.shape[0]
        perm, hub_mask = _locality_cell_order(cell_of_obs, pts_of_obs,
                                              V0, N)
        rank_v = np.empty(V0, np.int64)
        rank_v[perm] = np.arange(V0)
        cells_np = cells_np[perm]
        cell_of_obs = rank_v[cell_of_obs]
        if hub_mask is not None and hub_mask.any():
            hub_cell = rank_v[np.nonzero(hub_mask)[0]]
    six = np.arange(6)
    cols = np.concatenate(
        [
            cells_np[:, 0:1] * 6 + six,
            cells_np[:, 1:2] * 6 + six,
            6 * R_rows + cells_np[:, 2:3] * 6 + six,
        ],
        axis=1,
    ).astype(np.int32)
    cells = CellTable(
        slot_outer=jnp.asarray(cells_np[:, 0], jnp.int32),
        slot_inner=jnp.asarray(cells_np[:, 1], jnp.int32),
        slot_intr=jnp.asarray(cells_np[:, 2], jnp.int32),
        focal_shared=jnp.asarray(
            np.asarray(idx.focal_shared)[cells_np[:, 2]], dtype),
        dist_m1=jnp.asarray(np.asarray(idx.dist_m1)[cells_np[:, 2]], dtype),
        dist_m2=jnp.asarray(np.asarray(idx.dist_m2)[cells_np[:, 2]], dtype),
        cols=jnp.asarray(cols, jnp.int32),
    )

    # --- bucket points by padded track length (all-vectorized) ------------
    track = np.bincount(pts_of_obs, minlength=N).astype(np.int64)
    width = np.maximum(
        min_width,
        1 << np.ceil(np.log2(np.maximum(track, 1))).astype(np.int64),
    )
    width[track == 0] = 0

    order = np.argsort(pts_of_obs, kind="stable")
    sorted_pts = pts_of_obs[order]
    starts = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(track, out=starts[1:])
    slot_of_sorted = np.arange(order.size, dtype=np.int64) - starts[sorted_pts]

    widths = sorted(int(w) for w in np.unique(width) if w > 0)
    buckets = []
    row_of_point = np.zeros(N, dtype=np.int64)
    points_rows, free_rows = [], []
    pts_np = np.asarray(scene.params.points)
    pfree_np = (
        np.asarray(free.points) if free is not None
        else np.asarray(idx.point_mask)[:, None] * np.ones((1, 3))
    )
    pad_point = np.array([0.0, 0.0, 1.0])
    rank = np.full(N, -1, dtype=np.int64)
    alive_idx = np.nonzero(obs_alive)[0]
    slot_srcs = []           # per bucket: (Nb_pad, W) original obs id or -1
    # locality key: mean cell id of each point's observations. Ordering
    # bucket rows by it clusters co-visible points into the same chunks,
    # which is what makes the per-chunk local cell tables small (real
    # camera graphs index nearby cameras with nearby ids).
    V_cells = cells_np.shape[0]
    if hub_cell is not None:
        # hub observations carry no locality signal — key each point by
        # its NON-hub cells only (points seen solely by hubs fall back
        # to the plain statistics)
        w_obs = (~np.isin(cell_of_obs, hub_cell)).astype(np.float64)
    else:
        w_obs = np.ones(cell_of_obs.shape[0])
    cell_sum = np.zeros(N)
    np.add.at(cell_sum, pts_of_obs, cell_of_obs * w_obs)
    w_cnt = np.zeros(N)
    np.add.at(w_cnt, pts_of_obs, w_obs)
    all_sum = np.zeros(N)
    np.add.at(all_sum, pts_of_obs, cell_of_obs.astype(np.float64))
    mean_cell = np.where(
        w_cnt > 0, cell_sum / np.maximum(w_cnt, 1),
        all_sum / np.maximum(track, 1))
    # circular-mean key: capture paths are often CLOSED (turntables,
    # orbits), making the RCM band cyclic — a linear mean puts seam
    # points (windows straddling cell V-1 / 0) in the middle of the
    # order and pollutes many chunks. Per bucket, whichever key yields
    # the narrower measured chunk tables wins (_order_chunk_width).
    ang = 2.0 * np.pi * cell_of_obs / max(V_cells, 1)
    sin_sum = np.zeros(N)
    cos_sum = np.zeros(N)
    np.add.at(sin_sum, pts_of_obs, np.sin(ang) * w_obs)
    np.add.at(cos_sum, pts_of_obs, np.cos(ang) * w_obs)
    theta_cell = np.arctan2(sin_sum, cos_sum)
    offset = 0
    for W in widths:
        members = np.nonzero(width == W)[0]
        rpc_w = rows_per_chunk(W, chunk_obs)
        if locality:
            sel_mask = width[pts_of_obs] == W
            cands = [
                members[np.argsort(mean_cell[members], kind="stable")],
                members[np.argsort(theta_cell[members], kind="stable")],
            ]
            members = min(cands, key=lambda m: _order_chunk_width(
                m, rpc_w, pts_of_obs, cell_of_obs, sel_mask, N, V_cells))
        Nb = members.size
        rpc = rows_per_chunk(W, chunk_obs)
        Nb_pad = -(-Nb // rpc) * rpc
        rank[members] = np.arange(Nb)

        sel = np.nonzero(width[sorted_pts] == W)[0]
        rows = rank[sorted_pts[sel]]
        slots = slot_of_sorted[sel]
        src = order[sel]

        cell_b = np.zeros((Nb_pad, W), dtype=np.int32)
        xy0_b = np.zeros((Nb_pad, W))
        xy1_b = np.zeros((Nb_pad, W))
        mask_b = np.zeros((Nb_pad, W))
        cell_b[rows, slots] = cell_of_obs[src]
        xy0_b[rows, slots] = xy[src, 0]
        xy1_b[rows, slots] = xy[src, 1]
        mask_b[rows, slots] = 1.0
        if with_slot_src:
            src_b = np.full((Nb_pad, W), -1, dtype=np.int64)
            src_b[rows, slots] = alive_idx[src]
            slot_srcs.append(src_b)

        row_of_point[members] = offset + np.arange(Nb)
        points_rows.append(np.concatenate(
            [pts_np[members], np.tile(pad_point, (Nb_pad - Nb, 1))]))
        free_rows.append(np.concatenate(
            [pfree_np[members], np.zeros((Nb_pad - Nb, 3))]))
        bucket = TileBucket(
            cell=jnp.asarray(cell_b),
            xy0=jnp.asarray(xy0_b, dtype),
            xy1=jnp.asarray(xy1_b, dtype),
            mask=jnp.asarray(mask_b, dtype),
        )
        if locality:
            bucket = bucket_with_local(bucket, rpc, v_local_max)
        buckets.append(bucket)
        offset += Nb_pad

    # zero-track points: tail slice (no observations; deltas stay zero)
    tail = np.nonzero(width == 0)[0]
    if tail.size:
        row_of_point[tail] = offset + np.arange(tail.size)
        points_rows.append(pts_np[tail])
        free_rows.append(np.zeros((tail.size, 3)))
        offset += tail.size

    points_t = jnp.asarray(
        np.concatenate(points_rows) if points_rows else np.zeros((1, 3)),
        dtype,
    )
    free_t = jnp.asarray(
        np.concatenate(free_rows) if free_rows else np.zeros((1, 3)), dtype
    )
    tiles = TileIndex(
        cells=cells,
        buckets=tuple(buckets),
        row_of_point=jnp.asarray(row_of_point, jnp.int32),
    )
    params_t = dataclasses.replace(scene.params, points=points_t)
    if with_slot_src:
        return tiles, params_t, free_t, tuple(slot_srcs)
    return tiles, params_t, free_t


def unpermute_points(points_t: jnp.ndarray, tiles: TileIndex) -> jnp.ndarray:
    """Map permuted+padded row space back to original point order."""
    return points_t[tiles.row_of_point]


def with_cam_layout(tiles: TileIndex, min_width: int = 8,
                    max_width: int = 2048) -> TileIndex:
    """Attach the camera-major dual layout (host-side build, numpy sort).

    For each cell, its live point-major slots become one dense row (split
    across several rows when the cell sees more than ``max_width``
    observations; padded to the next power of two otherwise, with pads
    pointing at the sentinel slot M_flat which gathers zeros). ``pm_src``
    is the inverse map used to permute narrow per-slot intermediates from
    camera-major back to point-major flat order inside the dual sweeps.
    """
    if tiles.cam:
        return tiles
    V = int(tiles.cells.slot_outer.shape[0])
    cells_flat, live_flat = [], []
    for b in tiles.buckets:
        cells_flat.append(np.asarray(b.cell).reshape(-1))
        live_flat.append(np.asarray(b.mask).reshape(-1) > 0.5)
    cells_flat = np.concatenate(cells_flat)
    live = np.concatenate(live_flat)
    m_flat = cells_flat.shape[0]

    slot_ids = np.nonzero(live)[0].astype(np.int64)
    order = np.argsort(cells_flat[slot_ids], kind="stable")
    slot_sorted = slot_ids[order]
    counts = np.bincount(cells_flat[slot_ids], minlength=V)
    starts = np.concatenate([[0], np.cumsum(counts)])

    by_width: dict = {}          # S -> (list[cell_id], list[(S,) slot rows])
    for v in range(V):
        n = int(counts[v])
        if n == 0:
            continue
        sl = slot_sorted[starts[v]: starts[v] + n]
        pos = 0
        while n - pos >= max_width:
            rc, rows = by_width.setdefault(max_width, ([], []))
            rc.append(v)
            rows.append(sl[pos: pos + max_width])
            pos += max_width
        rem = n - pos
        if rem:
            S = max(min_width, 1 << (rem - 1).bit_length())
            row = np.full(S, m_flat, np.int64)
            row[:rem] = sl[pos:]
            rc, rows = by_width.setdefault(S, ([], []))
            rc.append(v)
            rows.append(row)

    pm_src = np.full(m_flat, -1, np.int64)
    cam_buckets = []
    cam_off = 0
    for S in sorted(by_width):
        rc, rows = by_width[S]
        rows = np.stack(rows)                      # (R, S)
        flat_pos = cam_off + np.arange(rows.size, dtype=np.int64)
        valid = rows.reshape(-1) < m_flat
        pm_src[rows.reshape(-1)[valid]] = flat_pos[valid]
        cam_buckets.append(CamBucket(
            row_cell=jnp.asarray(np.asarray(rc), jnp.int32),
            slot_idx=jnp.asarray(rows, jnp.int32),
        ))
        cam_off += rows.size
    pm_src[pm_src < 0] = cam_off                   # dead slots -> sentinel
    cam = CamLayout(
        buckets=tuple(cam_buckets),
        pm_src=jnp.asarray(pm_src, jnp.int32),
    )
    return tiles._replace(cam=(cam,))


# ---------------------------------------------------------------------------
# Packed cell-parameter table (one lookup per chunk serves everything)
# ---------------------------------------------------------------------------

# packed layout: R_i 0:9 | R_o 9:18 | R_oi 18:27 | t_i 27:30 | t_o 30:33 |
# Jr_o 33:42 | Jr_i 42:51 | center 51:53 | fx 53 | fy 54 | d0 55 | d1 56 |
# fs 57 | m1 58 | m2 59 | free18 60:78
PACKED_DIM = 78


def pack_cells(sp, cells: CellTable, cam_free: jnp.ndarray) -> jnp.ndarray:
    """(V, 78) packed per-cell derived parameters + freeze columns."""
    V = cells.slot_outer.shape[0]
    free18 = cam_free[cells.cols]
    parts = [
        sp.R_i.reshape(V, 9), sp.R_o.reshape(V, 9), sp.R_oi.reshape(V, 9),
        sp.t_i, sp.t_o, sp.Jr_o.reshape(V, 9), sp.Jr_i.reshape(V, 9),
        sp.center, sp.fx[:, None], sp.fy[:, None],
        sp.d0[:, None], sp.d1[:, None],
        cells.focal_shared[:, None], cells.dist_m1[:, None],
        cells.dist_m2[:, None], free18,
    ]
    return jnp.concatenate(parts, axis=1)


def _onehot(ids_flat: jnp.ndarray, V: int, dtype) -> jnp.ndarray:
    """Exact 0/1 one-hot (rows select table entries exactly under matmul)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (ids_flat.shape[0], V), 1)
    return (ids_flat[:, None] == iota).astype(dtype)


def _unpack(sl: jnp.ndarray, B: int, W: int) -> dict:
    """Packed chunk (B*W, 78) -> dict of per-(row, slot) tensors."""
    def t(a, b, shape=()):
        return sl[:, a:b].reshape((B, W) + (shape if shape else (b - a,)))

    return dict(
        R_i=t(0, 9, (3, 3)), R_o=t(9, 18, (3, 3)), R_oi=t(18, 27, (3, 3)),
        t_i=t(27, 30), t_o=t(30, 33),
        Jr_o=t(33, 42, (3, 3)), Jr_i=t(42, 51, (3, 3)),
        center=t(51, 53),
        fx=sl[:, 53].reshape(B, W), fy=sl[:, 54].reshape(B, W),
        d0=sl[:, 55].reshape(B, W), d1=sl[:, 56].reshape(B, W),
        fs=sl[:, 57].reshape(B, W), m1=sl[:, 58].reshape(B, W),
        m2=sl[:, 59].reshape(B, W), free18=t(60, 78),
    )


def _project_chunk(pts, c, xy0, xy1, mask):
    """Residual chain for one chunk (identical math to the grid engine,
    ``rig_grid.grid_jacobians`` — the closed form of
    ``src/snavely_reprojection_error.hh:38-118`` — with per-(row, slot)
    camera quantities instead of per-column)."""
    p2 = jnp.einsum("bwij,bj->bwi", c["R_i"], pts,
                    precision=HIGHEST) + c["t_i"]
    p3 = jnp.einsum("bwij,bwj->bwi", c["R_o"], p2,
                    precision=HIGHEST) + c["t_o"]
    z = p3[..., 2]
    # masked slots carry the pad cell; keep z away from 0 for them
    z = jnp.where(mask > 0.5, z, 1.0)
    inv_z = 1.0 / z
    u = p3[..., :2] * inv_z[..., None]
    r2 = jnp.sum(u * u, axis=-1)
    dcoef = 1.0 + r2 * (c["d0"] + c["d1"] * r2)
    f2 = jnp.stack([c["fx"], c["fy"]], axis=-1)
    pred = f2 * dcoef[..., None] * u + c["center"]
    r = (pred - jnp.stack([xy0, xy1], axis=-1)) * mask[..., None]
    return dict(p2=p2, inv_z=inv_z, u=u, r2=r2, dcoef=dcoef, f2=f2, r=r)


def _cross(v):
    """[v]_x for (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zr = jnp.zeros_like(x)
    return jnp.stack(
        [jnp.stack([zr, -z, y], -1), jnp.stack([z, zr, -x], -1),
         jnp.stack([-y, x, zr], -1)], axis=-2)


def _linearize_chunk(pts, c, xy0, xy1, mask, point_free, loss, loss_scale):
    """Closed-form Jacobian blocks for one chunk (masked + freeze-masked).

    Returns (cost, r (B,W,2), j_x (B,W,2,3), j_cam (B,W,2,18),
    g_p (B,3), hpp (B,3,3)). Derivative chain as in
    ``rig_grid.grid_jacobians`` (rotation derivatives via
    d(R(w) v)/dw = -R(w) [v]_x J_r(w), matching Ceres' Jets through the
    global angle-axis parameterization).
    """
    pc = _project_chunk(pts, c, xy0, xy1, mask)
    u, inv_z, r2, dcoef, f2 = (
        pc["u"], pc["inv_z"], pc["r2"], pc["dcoef"], pc["f2"]
    )
    r = pc["r"]
    raw_s = jnp.sum(r * r, axis=-1)
    cost = 0.5 * jnp.sum(loss_rho(raw_s, loss, loss_scale) * mask)
    mfac = mask
    if loss != "trivial":
        w = loss_weight(raw_s, loss, loss_scale)
        r = r * w[..., None]
        mfac = mask * w

    zero = jnp.zeros_like(inv_z)
    du_dp = jnp.stack(
        [
            jnp.stack([inv_z, zero, -u[..., 0] * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -u[..., 1] * inv_z], axis=-1),
        ],
        axis=-2,
    )                                             # (B, W, 2, 3)
    ddcoef = c["d0"] + 2.0 * c["d1"] * r2
    dr2_dp = 2.0 * jnp.einsum("bwk,bwka->bwa", u, du_dp, precision=HIGHEST)
    dres_dp = f2[..., None] * (
        dcoef[..., None, None] * du_dp
        + u[..., None] * (ddcoef[..., None] * dr2_dp)[..., None, :]
    )
    dres_dp = dres_dp * mfac[..., None, None]

    j_x = jnp.einsum("nwka,nwab->nwkb", dres_dp, c["R_oi"], precision=HIGHEST)
    j_to = dres_dp
    j_ti = jnp.einsum("nwka,nwab->nwkb", dres_dp, c["R_o"], precision=HIGHEST)
    dp3_dwo = -jnp.einsum(
        "bwij,bwjk,bwkl->bwil", c["R_o"], _cross(pc["p2"]), c["Jr_o"],
            precision=HIGHEST)
    j_wo = jnp.einsum("nwka,nwab->nwkb", dres_dp, dp3_dwo, precision=HIGHEST)
    dp3_dwi = -jnp.einsum(
        "bwij,bjk,bwkl->bwil", c["R_oi"], _cross(pts), c["Jr_i"],
            precision=HIGHEST)
    j_wi = jnp.einsum("nwka,nwab->nwkb", dres_dp, dp3_dwi, precision=HIGHEST)

    # intrinsics: [cx, cy, f0, f1, d0, d1]
    eye2 = jnp.eye(2, dtype=r.dtype)
    j_center = jnp.broadcast_to(eye2, r.shape + (2,)) * mfac[..., None, None]
    du_term = dcoef[..., None] * u
    sh = c["fs"] > 0.5
    j_f0 = jnp.stack(
        [du_term[..., 0], jnp.where(sh, du_term[..., 1], 0.0)], axis=-1)
    j_f1 = jnp.stack(
        [jnp.zeros_like(r2), jnp.where(sh, 0.0, du_term[..., 1])], axis=-1)
    j_focal = jnp.stack([j_f0, j_f1], axis=-1) * mfac[..., None, None]
    fu = f2 * u
    j_d0 = fu * (r2 * c["m1"])[..., None]
    j_d1 = fu * (r2 * r2 * c["m2"])[..., None]
    j_dist = jnp.stack([j_d0, j_d1], axis=-1) * mfac[..., None, None]
    j_intr = jnp.concatenate([j_center, j_focal, j_dist], axis=-1)

    j_cam = jnp.concatenate([j_wo, j_to, j_wi, j_ti, j_intr], axis=-1)
    j_cam = j_cam * c["free18"][:, :, None, :]
    j_x = j_x * point_free[:, None, None, :]

    g_p = jnp.einsum("bwki,bwk->bi", j_x, r, precision=HIGHEST)
    hpp = jnp.einsum("bwki,bwkj->bij", j_x, j_x, precision=HIGHEST)
    return cost, r, j_x, j_cam, g_p, hpp


# ---------------------------------------------------------------------------
# Chunked bucket sweeps
# ---------------------------------------------------------------------------


class BucketBlocks(NamedTuple):
    r: jnp.ndarray      # (Nb, W, 2) masked (+loss-weighted) residuals
    j_x: jnp.ndarray    # (Nb, W, 2, 3) point-freeze-masked
    j_cam: jnp.ndarray  # (Nb, W, 2, 18) camera-freeze-masked


class TileSystem(NamedTuple):
    cost: jnp.ndarray
    g_p: jnp.ndarray        # (Nrows, 3)
    hpp: jnp.ndarray        # (Nrows, 3, 3)
    g_c: jnp.ndarray        # (C,)
    hcc_cells: jnp.ndarray  # (V, 18, 18)
    hcc_diag: jnp.ndarray   # (C,)
    blocks: tuple           # tuple[BucketBlocks, ...] aligned with buckets


def _chunks(arr, B):
    n = arr.shape[0] // B
    return arr.reshape((n, B) + arr.shape[1:])


_TRIU_I, _TRIU_J = np.triu_indices(18)


def _sym_pack(h: jnp.ndarray) -> jnp.ndarray:
    """(..., 18, 18) symmetric -> (..., 171) upper-triangle pack."""
    return h[..., _TRIU_I, _TRIU_J]


def _sym_unpack(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 171) -> full symmetric (..., 18, 18)."""
    out = jnp.zeros(v.shape[:-1] + (18, 18), v.dtype)
    out = out.at[..., _TRIU_I, _TRIU_J].set(v)
    lower = jnp.swapaxes(out, -1, -2)
    diag = out * jnp.eye(18, dtype=v.dtype)
    return out + lower - diag


def cells_to_flat(vals: jnp.ndarray, cols: jnp.ndarray, C: int) -> jnp.ndarray:
    """(V, 18) cell-space values -> flat (C,) camera vector (tiny scatter)."""
    return jnp.zeros((C,), vals.dtype).at[cols.reshape(-1)].add(
        vals.reshape(-1))


def _bucket_blocking(b: TileBucket, chunk_obs: int, V: int):
    """(B rows/chunk, V_local, local-or-global cell plane, chunk tables).

    With locality blocking the chunk size is fixed by the stored tables
    (B = Nb / n_chunks); without it, by ``chunk_obs``. ``chunk_tables`` is
    None on the global path.
    """
    Nb, W = b.cell.shape
    if b.loc:
        local, chunk_cells = b.loc
        n_chunks = chunk_cells.shape[0]
        return Nb // n_chunks, chunk_cells.shape[1], local, chunk_cells
    return rows_per_chunk(W, chunk_obs), V, b.cell, None


def flat_to_cells(v: jnp.ndarray, cols: jnp.ndarray) -> jnp.ndarray:
    """Flat (C,) -> cell-space (V, 18) (tiny gather)."""
    return v[cols]


def _linearize_bucket_xla(pts_b, pf_b, b, packed, V, chunk_obs, loss,
                          loss_scale, bin_cam):
    """XLA chunk-path linearization of ONE bucket. Returns
    (cost, BucketBlocks, g_p (Nb,3), hpp (Nb,3,3), gc_c, hc_c,
    chunk_tables) — gc_c/hc_c per-chunk local bins when loc'd, else summed
    global bins (chunk_tables None)."""
    dtype = pts_b.dtype
    Nb, W = b.cell.shape
    B, Vl, plane, chunk_tables = _bucket_blocking(b, chunk_obs, V)

    def chunk_fn(args, B=B, W=W, Vl=Vl, local=chunk_tables is not None):
        pts, pf, cell, xy0, xy1, msk = args[:6]
        oh = _onehot(cell.reshape(-1), Vl, dtype)         # (B*W, Vl)
        table = packed[args[6]] if local else packed
        sl = jnp.dot(oh, table, preferred_element_type=dtype,
                     precision=HIGHEST)
        c = _unpack(sl, B, W)
        cost, r, j_x, j_cam, g_p, hpp = _linearize_chunk(
            pts, c, xy0, xy1, msk, pf, loss, loss_scale)
        if not bin_cam:
            z = jnp.zeros((), dtype)
            return cost, r, j_x, j_cam, g_p, hpp, z, z
        # camera-side binning shares the chunk's one-hot; the 18x18
        # Gram is symmetric, so only its 171 upper-triangle entries are
        # binned (the matmul is the dominant linearize cost)
        g18 = jnp.einsum("bwkc,bwk->bwc", j_cam, r,
                         precision=HIGHEST).reshape(B * W, 18)
        gc = jnp.dot(oh.T, g18, preferred_element_type=dtype,
                     precision=HIGHEST)
        h18 = _sym_pack(jnp.einsum("bwki,bwkj->bwij", j_cam, j_cam,
                                   precision=HIGHEST))
        hc = jnp.dot(
            oh.T, h18.reshape(B * W, 171), preferred_element_type=dtype,
                precision=HIGHEST)
        return cost, r, j_x, j_cam, g_p, hpp, gc, hc

    map_args = [_chunks(pts_b, B), _chunks(pf_b, B), _chunks(plane, B),
                _chunks(b.xy0, B), _chunks(b.xy1, B), _chunks(b.mask, B)]
    if chunk_tables is not None:
        map_args.append(chunk_tables)
    out = jax.lax.map(chunk_fn, tuple(map_args))
    cost_c, r_c, jx_c, jcam_c, gp_c, hpp_c, gc_c, hc_c = out
    blocks = BucketBlocks(
        r=r_c.reshape(Nb, W, 2),
        j_x=jx_c.reshape(Nb, W, 2, 3),
        j_cam=jcam_c.reshape(Nb, W, 2, 18),
    )
    return (jnp.sum(cost_c), blocks, gp_c.reshape(Nb, 3),
            hpp_c.reshape(Nb, 3, 3), gc_c, hc_c, chunk_tables)


def linearize_tiles(
    points_t: jnp.ndarray,
    packed: jnp.ndarray,
    tiles: TileIndex,
    point_free_t: jnp.ndarray,
    C: int,
    chunk_obs: int = CHUNK_OBS,
    loss: str = "trivial",
    loss_scale: float = 0.5,
    bin_cam: bool = True,
) -> TileSystem:
    """One full linearization over all buckets (XLA chunk path).

    ``bin_cam=False`` skips the in-chunk one-hot camera binning (g_c /
    hcc_cells / hcc_diag are returned as zeros); impl='dual' bins them
    through the camera-major layout instead (:func:`_dual_bin_system`).

    Buckets carrying locality blocking (``b.loc``) run every cell-space
    lookup/bin against the per-chunk LOCAL table (V_local wide) and only
    touch the global (V, .) arrays through tiny per-chunk gather/scatter.
    """
    V = packed.shape[0]
    dtype = points_t.dtype
    cols = tiles.cells.cols

    cost_total = jnp.zeros((), dtype)
    g_p_parts, hpp_parts, blocks = [], [], []
    g_cells = jnp.zeros((V, 18), dtype)
    hcc_packed = jnp.zeros((V, 171), dtype)

    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        pts_b = points_t[offset: offset + Nb]
        pf_b = point_free_t[offset: offset + Nb]
        cost_b, blk, gp_b, hpp_b, gc_c, hc_c, chunk_tables = (
            _linearize_bucket_xla(pts_b, pf_b, b, packed, V, chunk_obs,
                                  loss, loss_scale, bin_cam))
        cost_total = cost_total + cost_b
        g_p_parts.append(gp_b)
        hpp_parts.append(hpp_b)
        blocks.append(blk)
        if bin_cam and chunk_tables is not None:
            flat_ids = chunk_tables.reshape(-1)
            g_cells = g_cells.at[flat_ids].add(gc_c.reshape(-1, 18))
            hcc_packed = hcc_packed.at[flat_ids].add(hc_c.reshape(-1, 171))
        elif bin_cam:
            g_cells = g_cells + jnp.sum(gc_c, axis=0)
            hcc_packed = hcc_packed + jnp.sum(hc_c, axis=0)
        offset += Nb

    tail = points_t.shape[0] - offset
    if tail > 0:
        g_p_parts.append(jnp.zeros((tail, 3), dtype))
        hpp_parts.append(jnp.zeros((tail, 3, 3), dtype))

    hcc_cells = _sym_unpack(hcc_packed)
    return TileSystem(
        cost=cost_total,
        g_p=jnp.concatenate(g_p_parts),
        hpp=jnp.concatenate(hpp_parts),
        g_c=cells_to_flat(g_cells, cols, C),
        hcc_cells=hcc_cells,
        hcc_diag=cells_to_flat(
            jnp.diagonal(hcc_cells, axis1=-2, axis2=-1), cols, C),
        blocks=tuple(blocks),
    )


def tile_cost(
    points_t: jnp.ndarray,
    packed: jnp.ndarray,
    tiles: TileIndex,
    chunk_obs: int = CHUNK_OBS,
    loss: str = "trivial",
    loss_scale: float = 0.5,
) -> jnp.ndarray:
    """Residual-only robustified cost (the trial-evaluation pass)."""
    V = packed.shape[0]
    dtype = points_t.dtype
    total = jnp.zeros((), dtype)
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        B, Vl, plane, chunk_tables = _bucket_blocking(b, chunk_obs, V)
        pts_b = points_t[offset: offset + Nb]

        def chunk_fn(args, B=B, W=W, Vl=Vl, local=chunk_tables is not None):
            pts, cell, xy0, xy1, msk = args[:5]
            oh = _onehot(cell.reshape(-1), Vl, dtype)
            table = packed[args[5]] if local else packed
            sl = jnp.dot(oh, table, preferred_element_type=dtype,
                         precision=HIGHEST)
            c = _unpack(sl, B, W)
            pc = _project_chunk(pts, c, xy0, xy1, msk)
            s = jnp.sum(pc["r"] * pc["r"], axis=-1)
            return 0.5 * jnp.sum(loss_rho(s, loss, loss_scale) * msk)

        map_args = [_chunks(pts_b, B), _chunks(plane, B),
                    _chunks(b.xy0, B), _chunks(b.xy1, B), _chunks(b.mask, B)]
        if chunk_tables is not None:
            map_args.append(chunk_tables)
        costs = jax.lax.map(chunk_fn, tuple(map_args))
        total = total + jnp.sum(costs)
        offset += Nb
    return total


def tile_mse_planes(
    points_t: jnp.ndarray,
    packed: jnp.ndarray,
    tiles: TileIndex,
    chunk_obs: int = CHUNK_OBS,
) -> tuple:
    """Per-slot MSE planes ((r0^2 + r1^2) / 2, one (Nb, W) array per
    bucket) — the re-evaluation pass of ``filterPoint3d``
    (``src/DeepArcManager.cc:332-346``) in tile row space."""
    V = packed.shape[0]
    dtype = points_t.dtype
    planes = []
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        B, Vl, plane, chunk_tables = _bucket_blocking(b, chunk_obs, V)
        pts_b = points_t[offset: offset + Nb]

        def chunk_fn(args, B=B, W=W, Vl=Vl, local=chunk_tables is not None):
            pts, cell, xy0, xy1, msk = args[:5]
            oh = _onehot(cell.reshape(-1), Vl, dtype)
            table = packed[args[5]] if local else packed
            sl = jnp.dot(oh, table, preferred_element_type=dtype,
                         precision=HIGHEST)
            c = _unpack(sl, B, W)
            pc = _project_chunk(pts, c, xy0, xy1, msk)
            return 0.5 * jnp.sum(pc["r"] * pc["r"], axis=-1)

        map_args = [_chunks(pts_b, B), _chunks(plane, B),
                    _chunks(b.xy0, B), _chunks(b.xy1, B), _chunks(b.mask, B)]
        if chunk_tables is not None:
            map_args.append(chunk_tables)
        mse = jax.lax.map(chunk_fn, tuple(map_args))
        planes.append(mse.reshape(Nb, W))
        offset += Nb
    return tuple(planes)


def _e_sweep(
    tiles: TileIndex,
    sys: TileSystem,
    binv: jnp.ndarray,
    v_cells,
    rhs_mode: bool,
    chunk_obs: int = CHUNK_OBS,
) -> jnp.ndarray:
    """One fused observation sweep, binned to cell space (V, 18).

    rhs_mode=True:  E^T B^-1 g_p.
    rhs_mode=False: the Schur correction E^T B^-1 E v for cell-space v.
    B^-1 is row-local, so E v -> B^-1 -> E^T happens inside each chunk.
    """
    V = sys.hcc_cells.shape[0]
    dtype = sys.g_p.dtype
    out = jnp.zeros((V, 18), dtype)
    offset = 0
    for b, blk in zip(tiles.buckets, sys.blocks):
        Nb, W = b.cell.shape
        B, Vl, plane, chunk_tables = _bucket_blocking(b, chunk_obs, V)
        binv_b = binv[offset: offset + Nb]
        gp_b = sys.g_p[offset: offset + Nb]

        def chunk_fn(args, B=B, W=W, Vl=Vl, local=chunk_tables is not None):
            cell, j_x, j_cam, binv_c, gp_c = args[:5]
            oh = _onehot(cell.reshape(-1), Vl, dtype)
            if rhs_mode:
                w = jnp.einsum("bij,bj->bi", binv_c, gp_c, precision=HIGHEST)
            else:
                v_table = v_cells[args[5]] if local else v_cells
                vslot = jnp.dot(
                    oh, v_table, preferred_element_type=dtype,
                    precision=HIGHEST
                ).reshape(B, W, 18)
                t = jnp.einsum("bwkc,bwc->bwk", j_cam, vslot,
                               precision=HIGHEST)
                ev = jnp.einsum("bwki,bwk->bi", j_x, t, precision=HIGHEST)
                w = jnp.einsum("bij,bj->bi", binv_c, ev, precision=HIGHEST)
            t2 = jnp.einsum("bwki,bi->bwk", j_x, w, precision=HIGHEST)
            u = jnp.einsum("bwkc,bwk->bwc", j_cam, t2, precision=HIGHEST)
            return jnp.dot(oh.T, u.reshape(B * W, 18),
                           preferred_element_type=dtype, precision=HIGHEST)

        map_args = [_chunks(plane, B), _chunks(blk.j_x, B),
                    _chunks(blk.j_cam, B), _chunks(binv_b, B),
                    _chunks(gp_b, B)]
        if chunk_tables is not None:
            map_args.append(chunk_tables)
        parts = jax.lax.map(chunk_fn, tuple(map_args))
        if chunk_tables is not None:
            out = out.at[chunk_tables.reshape(-1)].add(parts.reshape(-1, 18))
        else:
            out = out + jnp.sum(parts, axis=0)
        offset += Nb
    return out


def _e_dot_cells(
    tiles: TileIndex,
    sys: TileSystem,
    v_cells: jnp.ndarray,
    chunk_obs: int = CHUNK_OBS,
) -> jnp.ndarray:
    """(E v) per point row (Nrows, 3), for cell-space v."""
    V = sys.hcc_cells.shape[0]
    dtype = sys.g_p.dtype
    parts = []
    used = 0
    for b, blk in zip(tiles.buckets, sys.blocks):
        Nb, W = b.cell.shape
        B, Vl, plane, chunk_tables = _bucket_blocking(b, chunk_obs, V)

        def chunk_fn(args, B=B, W=W, Vl=Vl, local=chunk_tables is not None):
            cell, j_x, j_cam = args[:3]
            oh = _onehot(cell.reshape(-1), Vl, dtype)
            v_table = v_cells[args[3]] if local else v_cells
            vslot = jnp.dot(
                oh, v_table, preferred_element_type=dtype,
                precision=HIGHEST
            ).reshape(B, W, 18)
            t = jnp.einsum("bwkc,bwc->bwk", j_cam, vslot, precision=HIGHEST)
            return jnp.einsum("bwki,bwk->bi", j_x, t, precision=HIGHEST)

        map_args = [_chunks(plane, B), _chunks(blk.j_x, B),
                    _chunks(blk.j_cam, B)]
        if chunk_tables is not None:
            map_args.append(chunk_tables)
        ev = jax.lax.map(chunk_fn, tuple(map_args))
        parts.append(ev.reshape(Nb, 3))
        used += Nb
    tail = sys.g_p.shape[0] - used
    if tail > 0:
        parts.append(jnp.zeros((tail, 3), dtype))
    return jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# Dual-layout sweeps (impl='dual')
# ---------------------------------------------------------------------------
# The one-hot sweeps above pay M x V x 18 multiply-adds per direction. The
# dual layout removes the one-hots entirely: j_cam is materialized ONCE per LM
# step in camera-major rows (CamLayout), where the cell-space lookup is a
# row broadcast and the binning is a within-row reduce. Each sweep then
# only permutes 2-float-per-slot intermediates between the layouts
# (cam-major pass A -> point-major B^-1 middle -> cam-major binning).


def _dual_prep(tiles: TileIndex, sys: TileSystem) -> tuple:
    """Camera-major copies of j_cam, one gather per LM step (reused by all
    PCG sweeps and the system binning)."""
    cam = tiles.cam[0]
    dtype = sys.g_p.dtype
    jcam_flat = jnp.concatenate(
        [blk.j_cam.reshape(-1, 2, 18) for blk in sys.blocks])
    jcam_pad = jnp.concatenate([jcam_flat, jnp.zeros((1, 2, 18), dtype)])
    return tuple(jcam_pad[cb.slot_idx] for cb in cam.buckets)


def _dual_bin_system(tiles: TileIndex, sys: TileSystem, jcam_cms: tuple,
                     V: int):
    """g_cells (V, 18) + hcc_cells (V, 18, 18) binned through the cam rows
    (replaces the one-hot gc/hc matmuls of linearize_tiles)."""
    cam = tiles.cam[0]
    dtype = sys.g_p.dtype
    r_flat = jnp.concatenate([blk.r.reshape(-1, 2) for blk in sys.blocks])
    r_pad = jnp.concatenate([r_flat, jnp.zeros((1, 2), dtype)])
    g = jnp.zeros((V, 18), dtype)
    h = jnp.zeros((V, 18, 18), dtype)
    for cb, jc in zip(cam.buckets, jcam_cms):
        r_cm = r_pad[cb.slot_idx]
        g = g.at[cb.row_cell].add(jnp.einsum("rskc,rsk->rc", jc, r_cm,
                                             precision=HIGHEST))
        h = h.at[cb.row_cell].add(jnp.einsum("rski,rskj->rij", jc, jc,
                                             precision=HIGHEST))
    return g, h


def _dual_pass_t(cam: CamLayout, jcam_cms: tuple, v_cells, dtype):
    """Pass A: t = J_cam v per slot in cam-major order, permuted back to
    point-major flat order (M_flat, 2)."""
    parts = [
        jnp.einsum("rskc,rc->rsk", jc, v_cells[cb.row_cell],
                   precision=HIGHEST).reshape(-1, 2)
        for cb, jc in zip(cam.buckets, jcam_cms)
    ]
    t_cm = jnp.concatenate(parts + [jnp.zeros((1, 2), dtype)])
    return t_cm[cam.pm_src]


def _dual_mid(sys: TileSystem, binv, t_pm, rhs_mode: bool):
    """Point-major middle: w = B^-1 (E v | g_p); returns t2 = J_x w per
    slot as point-major flat (M_flat, 2)."""
    t2_parts = []
    off_pt = off_slot = 0
    for blk in sys.blocks:
        Nb, W = blk.j_x.shape[:2]
        if rhs_mode:
            ev = sys.g_p[off_pt: off_pt + Nb]
        else:
            t_b = t_pm[off_slot: off_slot + Nb * W].reshape(Nb, W, 2)
            ev = jnp.einsum("bwki,bwk->bi", blk.j_x, t_b, precision=HIGHEST)
        w = jnp.einsum("bij,bj->bi", binv[off_pt: off_pt + Nb], ev,
                       precision=HIGHEST)
        t2_parts.append(jnp.einsum("bwki,bi->bwk", blk.j_x, w,
                                   precision=HIGHEST).reshape(-1, 2))
        off_pt += Nb
        off_slot += Nb * W
    return jnp.concatenate(t2_parts)


def _dual_sweep(tiles: TileIndex, sys: TileSystem, binv, jcam_cms: tuple,
                v_cells, rhs_mode: bool):
    """E^T B^-1 g_p (rhs_mode) or E^T B^-1 E v, binned to (V, 18)."""
    cam = tiles.cam[0]
    V = sys.hcc_cells.shape[0]
    dtype = sys.g_p.dtype
    t_pm = None if rhs_mode else _dual_pass_t(cam, jcam_cms, v_cells, dtype)
    t2_pm = _dual_mid(sys, binv, t_pm, rhs_mode)
    t2_pad = jnp.concatenate([t2_pm, jnp.zeros((1, 2), dtype)])
    out = jnp.zeros((V, 18), dtype)
    for cb, jc in zip(cam.buckets, jcam_cms):
        u = jnp.einsum("rskc,rsk->rc", jc, t2_pad[cb.slot_idx],
                       precision=HIGHEST)
        out = out.at[cb.row_cell].add(u)
    return out


def _dual_edot(tiles: TileIndex, sys: TileSystem, jcam_cms: tuple, v_cells):
    """(E v) per point row (Nrows, 3)."""
    cam = tiles.cam[0]
    dtype = sys.g_p.dtype
    t_pm = _dual_pass_t(cam, jcam_cms, v_cells, dtype)
    parts = []
    off_pt = off_slot = 0
    for blk in sys.blocks:
        Nb, W = blk.j_x.shape[:2]
        t_b = t_pm[off_slot: off_slot + Nb * W].reshape(Nb, W, 2)
        parts.append(jnp.einsum("bwki,bwk->bi", blk.j_x, t_b,
                                precision=HIGHEST))
        off_pt += Nb
        off_slot += Nb * W
    tail = sys.g_p.shape[0] - off_pt
    if tail > 0:
        parts.append(jnp.zeros((tail, 3), dtype))
    return jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# The LM step
# ---------------------------------------------------------------------------


class TileState(NamedTuple):
    points: jnp.ndarray   # (Nrows, 3) permuted+padded
    cam_vec: jnp.ndarray  # (C,)
    cost: jnp.ndarray
    tr: tr_mod.TRState
    k: jnp.ndarray
    status: jnp.ndarray


def _cell_slot_params(params: BAParams, cells: CellTable):
    from deeparc_tpu.solver.rig_grid import slot_params

    return slot_params(params, cells)


def _block_jacobi(sys: TileSystem, cells: CellTable, cam_aug, cam_free,
                  C: int):
    """6x6 block-Jacobi preconditioner assembled in cell space (the Ceres
    SCHUR_JACOBI analogue, camera-count independent)."""
    dtype = sys.hcc_cells.dtype
    n_rows6 = C // 6
    blocks = jnp.zeros((n_rows6, 6, 6), dtype)
    group_rows = (
        (cells.cols[:, 0] // 6, slice(0, 6)),
        (cells.cols[:, 6] // 6, slice(6, 12)),
        (cells.cols[:, 12] // 6, slice(12, 18)),
    )
    for row_ids, sl in group_rows:
        blocks = blocks.at[row_ids].add(sys.hcc_cells[:, sl, sl])
    aug = cam_aug.reshape(n_rows6, 6)
    frozen = 1.0 - cam_free.reshape(n_rows6, 6)
    eye6 = jnp.eye(6, dtype=dtype)
    blocks = blocks + eye6 * (aug + frozen)[:, :, None]
    inv_blocks = jnp.linalg.inv(blocks)

    def precond(v):
        vb = v.reshape(n_rows6, 6)
        return jnp.einsum("bij,bj->bi", inv_blocks, vb,
                          precision=HIGHEST).reshape(-1)

    return precond


def make_tile_step(options: SolverOptions, template: BAParams,
                   chunk_obs: int = CHUNK_OBS, axis: str | None = None,
                   impl: str = "xla"):
    """Pure LM step over the tile layout:
    step(state, tiles, cam_free, point_free_t) -> (state, info).

    With ``axis`` set the step is SPMD over that mesh axis: point rows (and
    bucket planes) are sharded; all cell-space reductions, the trial cost,
    and trust-region scalars are psum'd, exactly like the grid engine's
    distributed mode (SURVEY.md section 2.5).

    ``impl='xla'`` runs the one-hot chunk sweeps above. ``impl='dual'`` (fastest at large cell counts) uses the camera-major
    dual layout: requires ``with_cam_layout(tiles)``; sweeps and camera
    binning carry no one-hot matmuls at all (see the dual-layout section
    above). Single-device only for now (incompatible with ``axis``).
    """
    from deeparc_tpu.residuals.reprojection import camera_dim, unflatten_camera
    from deeparc_tpu.solver.ba import StepInfo

    if impl not in ("xla", "dual"):
        raise ValueError(f"tile engine impl must be 'xla' or 'dual', "
                         f"got {impl!r}")
    if impl == "dual" and axis is not None:
        raise ValueError("impl='dual' does not support the sharded step yet;"
                         " use impl='xla' with axis")

    C = camera_dim(template)

    if axis is None:
        allsum = allmax = lambda x: x
    else:
        allsum = lambda x: jax.lax.psum(x, axis)
        allmax = lambda x: jax.lax.pmax(x, axis)

    def _params_from(cam_vec, points):
        out = unflatten_camera(cam_vec, template)
        return dataclasses.replace(out, points=points)

    def step(state: TileState, tiles: TileIndex, cam_free, point_free_t):
        cols = tiles.cells.cols
        dtype = state.points.dtype
        params = _params_from(state.cam_vec, state.points)
        sp = _cell_slot_params(params, tiles.cells)
        packed = pack_cells(sp, tiles.cells, cam_free)

        sys = linearize_tiles(
            state.points, packed, tiles, point_free_t, C, chunk_obs,
            options.loss, options.loss_scale, bin_cam=(impl != "dual"))
        if impl == "dual":
            if not tiles.cam:
                raise ValueError(
                    "impl='dual' needs the camera-major layout; build the "
                    "TileIndex with with_cam_layout(tiles)")
            jcam_cms = _dual_prep(tiles, sys)
            g_cells, hcc = _dual_bin_system(
                tiles, sys, jcam_cms, tiles.cells.cols.shape[0])
            sys = sys._replace(
                g_c=cells_to_flat(g_cells, cols, C),
                hcc_cells=hcc,
                hcc_diag=cells_to_flat(
                    jnp.diagonal(hcc, axis1=-2, axis2=-1), cols, C),
            )
        if axis is None:
            sys = sys._replace(
                cost=allsum(sys.cost),
                g_c=allsum(sys.g_c),
                hcc_cells=allsum(sys.hcc_cells),
                hcc_diag=allsum(sys.hcc_diag),
            )
        else:
            # psum the SYMMETRIC cell Grams triu-packed: the (V, 18, 18)
            # Grams are the step's dominant collective payload (~5 MB at
            # V=2000 f32); packing moves 171/324 of the bytes, and the
            # flat diagonal is re-derived locally from the reduced Grams
            # instead of its own psum (VERDICT r3 item 7)
            hcc_cells = _sym_unpack(allsum(_sym_pack(sys.hcc_cells)))
            sys = sys._replace(
                cost=allsum(sys.cost),
                g_c=allsum(sys.g_c),
                hcc_cells=hcc_cells,
                hcc_diag=cells_to_flat(
                    jnp.diagonal(hcc_cells, axis1=-2, axis2=-1), cols, C),
            )

        # augmented per-point blocks
        diag = jnp.diagonal(sys.hpp, axis1=-2, axis2=-1)
        d2p = lm_diagonal(diag, options.min_lm_diagonal,
                          options.max_lm_diagonal)
        eye3 = jnp.eye(3, dtype=dtype)
        aug = sys.hpp + eye3 * d2p[:, :, None] / state.tr.radius
        aug = aug + (1.0 - point_free_t)[:, :, None] * eye3
        binv = inv3x3(aug)

        d2c = lm_diagonal(sys.hcc_diag, options.min_lm_diagonal,
                          options.max_lm_diagonal)
        cam_aug = d2c / state.tr.radius

        if impl == "dual":
            sweep_fn = lambda v_cells, rhs_mode: _dual_sweep(
                tiles, sys, binv, jcam_cms, v_cells, rhs_mode)
            edot_fn = lambda v_cells: _dual_edot(
                tiles, sys, jcam_cms, v_cells)
        else:
            sweep_fn = lambda v_cells, rhs_mode: _e_sweep(
                tiles, sys, binv, v_cells, rhs_mode, chunk_obs)
            edot_fn = lambda v_cells: _e_dot_cells(
                tiles, sys, v_cells, chunk_obs)

        rhs_cells = allsum(sweep_fn(None, True))
        rhs = (-sys.g_c + cells_to_flat(rhs_cells, cols, C)) * cam_free

        def hcc_matvec(v):
            v_cells = flat_to_cells(v, cols)
            out = jnp.einsum("vij,vj->vi", sys.hcc_cells, v_cells,
                             precision=HIGHEST)
            return cells_to_flat(out, cols, C)

        def matvec(v):
            vm = v * cam_free
            v_cells = flat_to_cells(vm, cols)
            corr_cells = allsum(sweep_fn(v_cells, False))
            s = (hcc_matvec(vm) + cam_aug * v
                 - cells_to_flat(corr_cells, cols, C))
            return jnp.where(cam_free > 0.5, s, v)

        precond = _block_jacobi(sys, tiles.cells, cam_aug, cam_free, C)
        result = pcg(
            matvec, rhs, precond=precond,
            max_iterations=options.cg_max_iterations,
            tol=options.cg_tolerance,
        )
        cg_used = result.iterations
        dc = result.x * cam_free

        dc_cells = flat_to_cells(dc, cols)
        e_dc = edot_fn(dc_cells)
        dp = -jnp.einsum("bij,bj->bi", binv, sys.g_p + e_dc,
                         precision=HIGHEST) * point_free_t

        # model cost change from the quadratic pieces
        dtg = (allsum(jnp.vdot(dp, sys.g_p, precision=HIGHEST))
               + jnp.vdot(dc, sys.g_c, precision=HIGHEST))
        dhd = (
            allsum(
                jnp.einsum("bi,bij,bj->", dp, sys.hpp, dp, precision=HIGHEST)
                + 2.0 * jnp.vdot(dp.reshape(-1), e_dc.reshape(-1),
                                 precision=HIGHEST)
            )
            + jnp.vdot(dc, hcc_matvec(dc), precision=HIGHEST)
        )
        mcc = -(dtg + 0.5 * dhd)

        new_points = state.points + dp
        new_cam = state.cam_vec + dc
        trial_params = _params_from(new_cam, new_points)
        trial_packed = pack_cells(
            _cell_slot_params(trial_params, tiles.cells), tiles.cells,
            cam_free)
        new_cost = allsum(tile_cost(
            new_points, trial_packed, tiles, chunk_obs,
            options.loss, options.loss_scale))

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
        next_state = TileState(
            points=points_next, cam_vec=cam_next, cost=cost_next,
            tr=tr_next, k=state.k + 1, status=jnp.asarray(status),
        )
        info = StepInfo(
            cost=cost_next, cost_change=cost_change, grad_max=grad_max,
            step_norm=step_norm, radius=state.tr.radius, rho=rho,
            accepted=accept, cg_iters=cg_used,
        )
        return next_state, info

    return step


def init_tile_state(
    params_t: BAParams, tiles: TileIndex, options: SolverOptions,
    cam_free=None, axis: str | None = None, chunk_obs: int = CHUNK_OBS,
) -> TileState:
    from deeparc_tpu.residuals.reprojection import flatten_camera

    dtype = params_t.points.dtype
    if cam_free is None:
        cam_free = jnp.ones(
            6 * params_t.ext_rot.shape[0] + 6 * params_t.center.shape[0],
            dtype)
    sp = _cell_slot_params(params_t, tiles.cells)
    packed = pack_cells(sp, tiles.cells, cam_free)
    cost0 = tile_cost(params_t.points, packed, tiles, chunk_obs,
                      options.loss, options.loss_scale)
    if axis is not None:
        cost0 = jax.lax.psum(cost0, axis)
    return TileState(
        points=params_t.points,
        cam_vec=flatten_camera(params_t),
        cost=cost0,
        tr=tr_mod.init_tr(options.initial_radius, dtype),
        k=jnp.asarray(0),
        status=jnp.asarray(0),
    )


def solve_ba_tiles(
    scene: Scene,
    free: BAParams,
    options: SolverOptions = SolverOptions(),
    driver: str = "python",
    chunk_obs: int = CHUNK_OBS,
    min_width: int = 4,
    impl: str = "xla",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    logger=None,
    while_block: int = 10,
    locality: bool = True,
):
    """LM to convergence on the tile engine, from a Scene.

    Returns a solver.ba.BAResult with points back in original order.
    Thin wrapper: builds the tile layout then delegates to
    :func:`solve_tiles_prepared`.
    """
    from deeparc_tpu.residuals.reprojection import flatten_camera

    tiles, params_t, free_t = tiles_from_scene(
        scene, free, min_width=min_width, chunk_obs=chunk_obs,
        locality=locality)
    return solve_tiles_prepared(
        params_t, tiles, free_t, flatten_camera(free), options,
        driver=driver, chunk_obs=chunk_obs, impl=impl,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        resume=resume, logger=logger, while_block=while_block,
    )


def solve_tiles_prepared(
    params_t: BAParams,
    tiles: TileIndex,
    free_t,
    cam_free,
    options: SolverOptions = SolverOptions(),
    driver: str = "python",
    chunk_obs: int = CHUNK_OBS,
    impl: str = "xla",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    logger=None,
    while_block: int = 10,
    unpermute: bool = True,
    _cache: dict | None = None,
):
    """LM to convergence on a PREPARED tile layout (row-space inputs).

    The pipeline's solve/filter loop calls this once per round with updated
    mask planes / freeze rows but identical shapes; passing the same
    ``_cache`` dict across rounds reuses the jitted step (zero recompiles
    after round one). ``unpermute=False`` returns points in row space.

    Operational features match the grid/indexed drivers (solve_ba_grid,
    solver/ba.py): wall-clock cap (``src/sfm.cc:71``), Ceres-style progress
    printing, periodic ``.npz`` solver-state checkpoints in ORIGINAL point
    order (engine-agnostic; ``resume=True`` re-permutes into tile row
    space), a JsonlLogger, and a blocked ``lax.while_loop`` driver with the
    time budget enforced on the host between blocks.
    """
    import time as _time

    from deeparc_tpu.residuals.reprojection import (
        flatten_camera, unflatten_camera,
    )
    from deeparc_tpu.solver.ba import BAResult

    if impl == "dual":
        tiles = with_cam_layout(tiles)
    cache = _cache if _cache is not None else {}
    if "step" not in cache:
        cache["step"] = make_tile_step(options, params_t, chunk_obs,
                                       impl=impl)
    step = cache["step"]
    state = init_tile_state(params_t, tiles, options, cam_free,
                            chunk_obs=chunk_obs)
    start_iter = 0
    if resume and checkpoint_path:
        import os as _os

        if _os.path.exists(checkpoint_path):
            from deeparc_tpu.utils.checkpoint import load_solver_state

            ck_params, scal = load_solver_state(
                checkpoint_path, dtype=params_t.points.dtype)
            # checkpoints store original point order; map into row space
            # (pad/dead rows keep their builder values — their mask is 0).
            points_ck = params_t.points.at[tiles.row_of_point].set(
                ck_params.points)
            params_ck = dataclasses.replace(ck_params, points=points_ck)
            sp = _cell_slot_params(params_ck, tiles.cells)
            packed = pack_cells(sp, tiles.cells, cam_free)
            cost_ck = tile_cost(points_ck, packed, tiles, chunk_obs,
                                options.loss, options.loss_scale)
            state = TileState(
                points=points_ck,
                cam_vec=flatten_camera(params_ck),
                cost=cost_ck,
                tr=tr_mod.TRState(
                    radius=jnp.asarray(scal["radius"],
                                       params_t.points.dtype),
                    decrease_factor=jnp.asarray(
                        scal["decrease_factor"], params_t.points.dtype),
                ),
                k=jnp.asarray(scal["iteration"]),
                status=jnp.asarray(0),
            )
            start_iter = scal["iteration"]

    def finish(st, k):
        out = unflatten_camera(st.cam_vec, params_t)
        pts = unpermute_points(st.points, tiles) if unpermute else st.points
        out = dataclasses.replace(out, points=pts)
        return BAResult(
            params=out, cost=float(st.cost),
            iterations=int(k), status=int(st.status),
        )

    def _save(st, k):
        from deeparc_tpu.utils.checkpoint import save_solver_state

        out = unflatten_camera(st.cam_vec, params_t)
        out = dataclasses.replace(
            out, points=unpermute_points(st.points, tiles))
        save_solver_state(
            checkpoint_path, out, float(st.tr.radius),
            float(st.tr.decrease_factor), k, float(st.cost),
        )

    if driver == "while_loop":
        if "jit_block" not in cache:
            cache["jit_block"] = jax.jit(
                lambda s, t, cf, pf, k_stop: jax.lax.while_loop(
                    lambda st: (st.status == 0) & (st.k < k_stop),
                    lambda st: step(st, t, cf, pf)[0],
                    s,
                )
            )
        jit_block = cache["jit_block"]
        t0 = _time.time()
        k = start_iter
        while int(state.status) == 0 and k < options.max_iterations:
            if _time.time() - t0 > options.max_seconds:
                break
            k_stop = min(k + while_block, options.max_iterations)
            state = jit_block(state, tiles, cam_free, free_t,
                              jnp.asarray(k_stop))
            k = int(state.k)
            if checkpoint_path:
                _save(state, k)
        return finish(state, k)

    if "jit_step" not in cache:
        cache["jit_step"] = jax.jit(step)
    jit_step = cache["jit_step"]
    t0 = _time.time()
    k = start_iter
    while int(state.status) == 0 and k < options.max_iterations:
        if _time.time() - t0 > options.max_seconds:
            break
        state, info = jit_step(state, tiles, cam_free, free_t)
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
    return finish(state, k)
