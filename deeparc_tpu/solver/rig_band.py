"""Live-band preparation for the grid engine (host-side, one-time).

The dense-grid kernels pay for every (point, cell) slot; at sparse
visibility most slots are dead. Real visibility is not uniform-random:
a surface point on a turntable rig is seen from a contiguous CYCLIC window
of rotation positions (self-occlusion), and general SfM camera graphs have
the same co-visibility locality the tile engine exploits with RCM
(solver/tiles.py). This module finds that structure for the grid layout:

1. **Cell ordering** — try several cell renumberings (identity, reverse
   Cuthill-McKee on the cell co-visibility graph, and a spectral CYCLIC
   embedding: the angle of the two leading nontrivial eigenvectors of the
   co-visibility operator, which recovers ring order on turntable rigs
   without RCM's cycle-folding) and keep whichever yields the narrowest
   bands.
2. **Point ordering** — sort points by the circular mean of their visible
   cells, so each kernel tile of ``block_np`` points shares one band.
3. **Band table** — per point tile, the minimal cyclic window of 8-cell
   slabs covering every live cell; the static band width is the max over
   tiles. Wrapped windows are handled by a cyclic plane extension
   (:func:`banded_planes`): band rows index cells modulo ``t_pad``.

All heavy reductions (co-visibility Gram, tile liveness) run ON DEVICE;
only (T, T)- and (n_tiles, nb)-sized summaries cross to the host.

If no ordering produces a band narrower than ``max_frac * t_pad`` (e.g.
uniform-random visibility, or a dense rig) the prep returns None and the
caller uses the unbanded paths — banding is an optimization, never a
requirement. The reference bar: Ceres only ever evaluates real residual
blocks (``/root/reference/src/sfm.cc:36-48``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deeparc_tpu.solver.linalg import HIGHEST
from deeparc_tpu.solver.rig_grid import GridIndex


class BandPrep(NamedTuple):
    grid: GridIndex      # cell-renumbered, point-sorted; band=(starts_lin,
    #                      starts_cost) attached
    w_band: int          # max band width (cells) over lin groups (logging)
    w_band_cost: int     # max band width over cost groups (logging)
    perm: jnp.ndarray    # (N,) sorted row i holds original point perm[i]
    inv: jnp.ndarray     # (N,) original point p sits at sorted row inv[p]
    block_np: int = 256        # point-tile width the lin table was built for
    cost_block_np: int = 1024  # point-tile width the cost table was built for
    # width-bucketed tile groups ((w, tile_lo, tile_hi), ...): tiles are
    # reordered so each group is a contiguous tile range paying its OWN
    # band width instead of the global max (in-band dead work fix)
    lin_groups: tuple = ()
    cost_groups: tuple = ()
    cell_perm: jnp.ndarray | None = None   # new cell rank -> old cell id

    @property
    def widths(self):
        """(band_widths, band_blocks) for make_grid_step/init_grid_state."""
        return ((self.lin_groups or self.w_band,
                 self.cost_groups or self.w_band_cost),
                (self.block_np, self.cost_block_np))

    @property
    def slot_work(self):
        """(paid_slot_cells, uniform_slot_cells) for the lin tiling — the
        bench's auditable 'how much dead work does the band still pay'."""
        paid = sum(w * (hi - lo) for w, lo, hi in self.lin_groups)
        n_tiles = self.lin_groups[-1][2] if self.lin_groups else 0
        return paid * self.block_np, self.w_band * n_tiles * self.block_np


def _partition_widths(covers8: np.ndarray, max_groups: int):
    """Optimal contiguous partition of SORTED tile covers into <= max_groups
    width buckets minimizing total paid slabs sum(n_g * max_g).

    Returns the bucket width (in 8-cell slabs, >= 1) per TILE (unsorted
    order). O(G * n^2) exact DP on the host; n_tiles is ~1e3."""
    n = covers8.shape[0]
    order = np.argsort(covers8, kind="stable")
    c = np.maximum(covers8[order].astype(np.float64), 1.0)
    # dp[g][i] = min paid slabs for sorted tiles [i, n) with <= g groups;
    # the first group is [i, j), paying (j - i) * c[j-1]
    dp_prev = (n - np.arange(n + 1)) * c[-1]          # <= 1 group
    dp_prev[n] = 0.0
    cuts = [None]  # cuts[g][i] = first cut j for <= g+1 groups
    for _ in range(2, max_groups + 1):
        dp = np.zeros(n + 1)
        cut = np.full(n + 1, n, np.int64)
        for i in range(n - 1, -1, -1):
            v = np.arange(1, n - i + 1) * c[i:] + dp_prev[i + 1:]
            j = int(np.argmin(v))
            dp[i] = v[j]
            cut[i] = i + 1 + j
        dp_prev, _ = dp, cuts.append(cut)
    widths_sorted = np.empty(n, np.int64)
    g, i = len(cuts) - 1, 0
    while i < n:
        j = int(cuts[g][i]) if g >= 1 and cuts[g] is not None else n
        widths_sorted[i:j] = int(c[j - 1])
        i, g = j, max(g - 1, 0)
    out = np.empty(n, np.int64)
    out[order] = widths_sorted
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_planes_t(x, t_pad, n_pad):
    """(N, T) -> transposed, padded (t_pad, n_pad)."""
    xt = x.T
    T, N = xt.shape
    return jnp.pad(xt, ((0, t_pad - T), (0, n_pad - N)))


def banded_planes(grid: GridIndex, n_pad: int, ext_len: int):
    """Stacked + cyclically-extended observation planes
    (3, t_pad + ext_len, n_pad): [xy0; xy1; mask] transposed; row
    ``t_pad + j`` repeats cell row ``j`` so wrapped bands are contiguous."""
    t_pad = _round_up(grid.xy0.shape[1], 8)
    stack = jnp.stack([
        _pad_planes_t(grid.xy0, t_pad, n_pad),
        _pad_planes_t(grid.xy1, t_pad, n_pad),
        _pad_planes_t(grid.mask, t_pad, n_pad),
    ])
    rows = jnp.arange(t_pad + ext_len) % t_pad
    return stack[:, rows]


def gather_banded_planes(pxm_ext, starts, w_band, block_np,
                         t_lo=0, t_hi=None):
    """Pre-gather each point tile's live band into a DENSE stack
    (3, w_band, (t_hi - t_lo) * block_np): tile i's lane block holds rows
    [starts[i]*8, starts[i]*8 + w_band) of the extended planes. The planes
    are constant across LM iterations, so this is one gather per solve.
    ``t_lo``/``t_hi`` restrict to a width-bucketed tile group (per-group
    stacks pay each group's own band width)."""
    _, t_ext, n_pad = pxm_ext.shape
    n_tiles = n_pad // block_np
    if t_hi is None:
        t_hi = n_tiles
    starts_g = starts[t_lo:t_hi]
    rows = starts_g[:, None] * 8 + jnp.arange(w_band, dtype=starts.dtype)
    arr = pxm_ext.reshape(3, t_ext, n_tiles, block_np)[:, :, t_lo:t_hi]
    idx = rows.T[None, :, :, None]           # (1, w_band, t_hi - t_lo, 1)
    out = jnp.take_along_axis(arr, idx, axis=1)
    return out.reshape(3, w_band, (t_hi - t_lo) * block_np)


def band_groups(w_band, n_pad, block_np):
    """Normalize a band spec to ``((w, tile_lo, tile_hi), ...)``: either a
    tuple of width-bucket groups (band_grid's lin/cost groups) or one
    static width paid by every tile of ``n_pad / block_np``."""
    if isinstance(w_band, tuple):
        return w_band
    return ((w_band, 0, n_pad // block_np),)


def _cell_orderings(cooc: np.ndarray, names) -> list:
    """Candidate cell permutations (each maps new rank -> old cell id)."""
    T = cooc.shape[0]
    out = []
    if "identity" in names:
        out.append(np.arange(T, dtype=np.int64))
    if "rcm" in names and T > 2:
        try:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            adj = sp.csr_matrix((cooc > 0).astype(np.float32))
            out.append(np.asarray(
                reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64))
        except Exception:
            pass
    if "spectral" in names and T > 3:
        # cyclic embedding: leading nontrivial eigenvectors of the
        # degree-normalized co-visibility operator trace out the circle for
        # cyclically-banded graphs; ordering cells by their angle recovers
        # the ring order without cutting the cycle
        a = cooc.astype(np.float64)
        d = np.maximum(a.sum(axis=1), 1e-9)
        a = a / np.sqrt(d[:, None] * d[None, :])
        vals, vecs = np.linalg.eigh(a)
        v1, v2 = vecs[:, -2], vecs[:, -3]
        out.append(np.argsort(np.arctan2(v2, v1)).astype(np.int64))
    return out


@jax.jit
def _point_order(mask, cell_perm):
    """Device: circular-mean cell angle per point -> sorted point order."""
    T = mask.shape[1]
    m = mask[:, cell_perm]
    ang = 2.0 * jnp.pi * jnp.arange(T, dtype=mask.dtype) / T
    theta = jnp.arctan2(m @ jnp.sin(ang), m @ jnp.cos(ang))
    return jnp.argsort(theta, stable=True)


def _tile_liveness(mask, order, cell_perm, t_pad, bn, n_pad):
    """Device: (n_tiles, t_pad/8) slab-liveness of the sorted+permuted mask."""
    N, T = mask.shape
    m = mask[order][:, cell_perm]
    m = jnp.pad(m, ((0, n_pad - N), (0, t_pad - T)))
    return jnp.asarray(
        m.reshape(n_pad // bn, bn, t_pad // 8, 8).sum(axis=(1, 3)) > 0.5)


def _covers_from_liveness(lv: np.ndarray):
    """Host: per-tile minimal cyclic 8-block window -> (starts8, covers8)."""
    n_tiles, nb = lv.shape
    starts = np.zeros(n_tiles, np.int32)
    covers = np.ones(n_tiles, np.int32)
    for i, row in enumerate(lv):
        pos = np.nonzero(row)[0]
        if pos.size == 0:
            covers[i] = 0
            continue
        gaps = np.diff(np.concatenate([pos, [pos[0] + nb]]))
        gmax = int(np.argmax(gaps))
        starts[i] = pos[(gmax + 1) % pos.size]
        covers[i] = nb - int(gaps[gmax]) + 1
    return starts, covers


def _partition_sequence(covers8: np.ndarray, max_groups: int, t_pad: int):
    """Contiguous sequence partition (NO reorder) of tile covers into
    <= max_groups segments minimizing sum(len_g * max_g). For the cost
    tiling, whose point order is already fixed by the lin-tile reorder.
    Returns ((w_cells, lo, hi), ...)."""
    n = covers8.shape[0]
    if n == 0:
        return ((8, 0, 0),)
    cap = t_pad // 8
    c = np.minimum(np.maximum(covers8.astype(np.int64), 1), cap)
    INF = float("inf")
    # dp[g][i] = min cost for tiles [i, n) with <= g segments
    dp_prev = np.full(n + 1, INF)
    dp_prev[n] = 0.0
    run = c[::-1]
    run = np.maximum.accumulate(run)[::-1]          # max(c[i:])
    for i in range(n):
        dp_prev[i] = (n - i) * run[i]
    cuts = [None]
    for _ in range(2, max_groups + 1):
        dp = np.full(n + 1, INF)
        dp[n] = 0.0
        cut = np.full(n + 1, n, np.int64)
        for i in range(n - 1, -1, -1):
            m = 0
            best, bj = INF, n
            for j in range(i + 1, n + 1):
                if c[j - 1] > m:
                    m = c[j - 1]
                v = (j - i) * m + dp_prev[j]
                if v < best:
                    best, bj = v, j
            dp[i] = best
            cut[i] = bj
        dp_prev, _ = dp, cuts.append(cut)
    groups = []
    g, i = len(cuts) - 1, 0
    while i < n:
        j = int(cuts[g][i]) if g >= 1 and cuts[g] is not None else n
        groups.append((int(c[i:j].max()) * 8, i, j))
        i, g = j, max(g - 1, 0)
    return tuple(groups)


def _group_tiles(covers8, max_groups):
    """Bucket tiles by cover width and produce the width-sorted tile order.

    Tiles keep their relative (angular) order INSIDE each bucket so
    coarser tilings built on top (the cost pass) still see angular
    locality. Returns (tile_order, groups) with groups a tuple of
    (w_cells, tile_lo, tile_hi) over the REORDERED tile sequence."""
    if covers8.size == 0:
        return np.zeros((0,), np.int64), ()
    buckets = _partition_widths(covers8, max_groups)
    tile_order = np.argsort(buckets, kind="stable")
    b_sorted = buckets[tile_order]
    groups = []
    lo = 0
    for w in np.unique(b_sorted):
        hi = int(np.searchsorted(b_sorted, w, side="right"))
        groups.append((int(w) * 8, lo, hi))
        lo = hi
    return tile_order, tuple(groups)


def band_grid(
    grid: GridIndex,
    block_np: int = 256,
    cost_block_np: int = 1024,
    max_frac: float = 0.85,
    orderings=("identity", "rcm", "spectral"),
    max_groups: int = 4,
    max_groups_cost: int = 3,
) -> BandPrep | None:
    """Build the banded layout, or None when banding would not pay.

    The caller must permute point-indexed arrays (``params.points``, the
    point freeze mask) by ``prep.perm`` before solving and map results back
    with ``prep.inv`` (or ``prep.perm`` as a gather). Cell renumbering is
    internal to the returned GridIndex — slot tables and one-hots are
    permuted consistently, so solve semantics are unchanged.
    """
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    if T < 16:
        return None
    # one shared padded width serves both kernels' tile grids (the cost
    # pass uses wider point tiles) and the prebuilt plane stacks
    assert max(block_np, cost_block_np) % min(block_np, cost_block_np) == 0
    n_pad = _round_up(N, max(block_np, cost_block_np))
    cooc = np.asarray(
        jnp.einsum("nt,nu->tu", grid.mask, grid.mask,  # (T, T), tiny
                   precision=HIGHEST))

    best = None
    for cell_perm in _cell_orderings(cooc, orderings):
        cp = jnp.asarray(cell_perm)
        order = _point_order(grid.mask, cp)
        lv = np.asarray(_tile_liveness(grid.mask, order, cp, t_pad,
                                       block_np, n_pad))
        starts, covers = _covers_from_liveness(lv)
        # selection metric = the PAID slot work after width bucketing, not
        # the global max (a single wide tile no longer taxes every tile);
        # only tiles holding real points count (trailing all-padding tiles
        # have cover 0 and would dilute the density estimate)
        n_live = -(-N // block_np)
        paid = _partition_widths(covers[:n_live], max_groups)
        work = int(paid.sum())
        if best is None or work < best[0]:
            best = (work, cp, order, starts, covers)
    work, cell_perm, order, starts, covers = best
    n_tiles = n_pad // block_np
    n_live = -(-N // block_np)
    if work * 8 >= max_frac * t_pad * n_live:
        return None

    # ---- width-bucketed tile reorder (per-tile band cost) ----
    # Only FULL tiles are reordered; tiles overlapping the [N, n_pad)
    # padding must stay trailing so the padded-row layout the kernels
    # build (pad at the end) keeps tile boundaries aligned.
    n_full = N // block_np
    tile_order_full, lin_groups = _group_tiles(covers[:n_full], max_groups)
    tile_order = np.concatenate(
        [tile_order_full, np.arange(n_full, n_tiles)])
    if n_full < n_tiles:
        w_tail = max(int(covers[n_full:].max()), 1) * 8
        lin_groups = lin_groups + ((w_tail, n_full, n_tiles),)
    starts = starts[tile_order]
    order_np = np.asarray(order)
    full_rows = order_np[: n_full * block_np].reshape(n_full, block_np)
    order = jnp.asarray(np.concatenate(
        [full_rows[tile_order_full].reshape(-1),
         order_np[n_full * block_np:]]))
    w_band = max(w for w, _, _ in lin_groups)

    # cost tiling: computed on the FINAL point order; cost tiles cannot be
    # reordered (the point layout is fixed), so group them by a contiguous
    # sequence partition instead of sorting
    lv_cost = np.asarray(
        _tile_liveness(grid.mask, order, cell_perm, t_pad, cost_block_np,
                       n_pad))
    starts_cost, covers_cost = _covers_from_liveness(lv_cost)
    cost_groups = _partition_sequence(covers_cost, max_groups_cost, t_pad)
    w_cost = max(w for w, _, _ in cost_groups)

    new_grid = grid._replace(
        xy0=grid.xy0[order][:, cell_perm],
        xy1=grid.xy1[order][:, cell_perm],
        mask=grid.mask[order][:, cell_perm],
        point_mask=grid.point_mask[order],
        slot_outer=grid.slot_outer[cell_perm],
        slot_inner=grid.slot_inner[cell_perm],
        slot_intr=grid.slot_intr[cell_perm],
        onehot_outer=grid.onehot_outer[cell_perm],
        onehot_inner=grid.onehot_inner[cell_perm],
        onehot_intr=grid.onehot_intr[cell_perm],
        focal_shared=grid.focal_shared[cell_perm],
        dist_m1=grid.dist_m1[cell_perm],
        dist_m2=grid.dist_m2[cell_perm],
    )
    # pre-gathered per-tile band planes: the observation planes never
    # change during LM, so ONE gather per solve serves every iteration
    pxm_ext = banded_planes(new_grid, n_pad, max(w_band, w_cost))
    starts_d = jnp.asarray(starts)
    starts_cost_d = jnp.asarray(starts_cost)
    pxm_lin = tuple(
        gather_banded_planes(pxm_ext, starts_d, w, block_np, lo, hi)
        for w, lo, hi in lin_groups)
    pxm_cost = tuple(
        gather_banded_planes(pxm_ext, starts_cost_d, w, cost_block_np,
                             lo, hi)
        for w, lo, hi in cost_groups)
    new_grid = new_grid._replace(
        band=(starts_d, starts_cost_d, pxm_lin, pxm_cost))
    inv = jnp.argsort(order)
    return BandPrep(grid=new_grid, w_band=int(w_band),
                    w_band_cost=int(w_cost), perm=order, inv=inv,
                    block_np=block_np, cost_block_np=cost_block_np,
                    lin_groups=lin_groups, cost_groups=cost_groups,
                    cell_perm=jnp.asarray(cell_perm))


def band_grid_update(prep: BandPrep, grid: GridIndex) -> BandPrep:
    """Refresh a BandPrep for an UPDATED visibility mask of the same scene.

    The pipeline's filter rounds only REMOVE observations
    (``DeepArcManager::filterPoint3d`` semantics), so the stored band
    covers remain valid covers of the shrunk mask; orderings, band
    widths, groups, and start tables are all reused — every solve of the
    loop then shares ONE compiled step instead of re-prepping and
    re-compiling per round. Only the observation planes are re-gathered,
    on device."""
    assert prep.cell_perm is not None, "prep predates cell_perm storage"
    order, cp = prep.perm, prep.cell_perm
    g = prep.grid._replace(
        xy0=grid.xy0[order][:, cp],
        xy1=grid.xy1[order][:, cp],
        mask=grid.mask[order][:, cp],
        point_mask=grid.point_mask[order],
    )
    starts_d, starts_cost_d = prep.grid.band[0], prep.grid.band[1]
    N = grid.xy0.shape[0]
    n_pad = -(-N // max(prep.block_np, prep.cost_block_np)) * max(
        prep.block_np, prep.cost_block_np)
    pxm_ext = banded_planes(g, n_pad, max(prep.w_band, prep.w_band_cost))
    pxm_lin = tuple(
        gather_banded_planes(pxm_ext, starts_d, w, prep.block_np, lo, hi)
        for w, lo, hi in prep.lin_groups)
    pxm_cost = tuple(
        gather_banded_planes(pxm_ext, starts_cost_d, w, prep.cost_block_np,
                             lo, hi)
        for w, lo, hi in prep.cost_groups)
    g = g._replace(band=(starts_d, starts_cost_d, pxm_lin, pxm_cost))
    return prep._replace(grid=g)
