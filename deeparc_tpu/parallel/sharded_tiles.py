"""Distributed tile-engine bundle adjustment: point rows sharded over a mesh.

The BAL/config-5 distributed path (BASELINE.json): the tile engine's
point-major layout makes data parallelism trivial — bucket rows (and the
matching point/freeze rows) are partitioned over the mesh axis (or the
("host", "chip") axis pair), every per-point quantity is shard-local, and
only the SMALL cell-space camera reductions ((V, 18) gradients, (V, 18, 18)
Grams, the PCG rhs/correction bins, and trust-region scalars) cross the
interconnect via psum — a few MB per LM iteration regardless of problem
size. The step function is ``tiles.make_tile_step(axis=...)`` — the exact
single-chip code with its cross-row reductions routed through psum/pmax, so
distributed iterates match single-device iterates up to float
re-association (asserted in tests/test_dist.py-style tile tests).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.scene import BAParams
from deeparc_tpu.solver.tiles import (
    CHUNK_OBS,
    TileBucket,
    TileIndex,
    init_tile_state,
    make_tile_step,
)


def shard_tile_rows(params_t: BAParams, tiles: TileIndex, point_free_t,
                    n_shards: int, chunk_obs: int = CHUNK_OBS):
    """Pad every bucket's rows so each splits evenly into n_shards
    chunk-aligned slices, and reorder the row-space point arrays
    SHARD-MAJOR: shard s's contiguous global slice is
    [bucket0 slice s | bucket1 slice s | ... | tail slice s], matching the
    per-bucket slices ``P(axis)`` hands each shard.

    Returns (params_p, tiles_p, point_free_p, orig_row_of_row) where
    ``orig_row_of_row`` maps the reordered global rows back to pre-pad rows
    (-1 for padding)."""
    from deeparc_tpu.solver.tiles import rows_per_chunk

    pts = np.asarray(params_t.points)
    pf = np.asarray(point_free_t)
    dtype = params_t.points.dtype
    pad_point = np.array([0.0, 0.0, 1.0])

    new_buckets = []
    # per-bucket padded (points, free, orig) blocks, kept for interleaving
    blocks = []
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        if b.loc:
            rpc = Nb // b.loc[1].shape[0]   # loc blocking fixes rows/chunk
        else:
            rpc = rows_per_chunk(W, chunk_obs)
        quantum = n_shards * rpc
        Nb_pad = -(-Nb // quantum) * quantum
        pad = Nb_pad - Nb

        def pad_rows(arr, fill=0.0):
            arr = np.asarray(arr)
            return np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])

        loc = ()
        if b.loc:
            local, chunk_cells = b.loc
            pad_chunks = Nb_pad // rpc - chunk_cells.shape[0]
            loc = (
                jnp.asarray(pad_rows(local)),
                jnp.asarray(np.concatenate([
                    np.asarray(chunk_cells),
                    np.zeros((pad_chunks, chunk_cells.shape[1]), np.int32),
                ])),
            )
        new_buckets.append(TileBucket(
            cell=jnp.asarray(pad_rows(b.cell)),
            xy0=jnp.asarray(pad_rows(b.xy0), dtype),
            xy1=jnp.asarray(pad_rows(b.xy1), dtype),
            mask=jnp.asarray(pad_rows(b.mask), dtype),
            loc=loc,
        ))
        blocks.append((
            np.concatenate([pts[offset: offset + Nb],
                            np.tile(pad_point, (pad, 1))]),
            np.concatenate([pf[offset: offset + Nb], np.zeros((pad, 3))]),
            np.concatenate([np.arange(offset, offset + Nb),
                            np.full(pad, -1, dtype=np.int64)]),
        ))
        offset += Nb

    # tail rows (zero-track points) pad to the shard count
    tail = pts.shape[0] - offset
    if tail > 0:
        tail_pad = -(-tail // n_shards) * n_shards - tail
        blocks.append((
            np.concatenate([pts[offset:],
                            np.tile(pad_point, (tail_pad, 1))]),
            np.concatenate([pf[offset:], np.zeros((tail_pad, 3))]),
            np.concatenate([np.arange(offset, offset + tail),
                            np.full(tail_pad, -1, dtype=np.int64)]),
        ))

    # shard-major interleave
    pts_rows, pf_rows, orig_rows = [], [], []
    for s in range(n_shards):
        for blk_pts, blk_pf, blk_orig in blocks:
            per = blk_pts.shape[0] // n_shards
            pts_rows.append(blk_pts[s * per: (s + 1) * per])
            pf_rows.append(blk_pf[s * per: (s + 1) * per])
            orig_rows.append(blk_orig[s * per: (s + 1) * per])

    params_p = dataclasses.replace(
        params_t, points=jnp.asarray(np.concatenate(pts_rows), dtype))
    point_free_p = jnp.asarray(np.concatenate(pf_rows), dtype)
    tiles_p = TileIndex(
        cells=tiles.cells, buckets=tuple(new_buckets),
        row_of_point=tiles.row_of_point,   # remapped by the caller if needed
    )
    return params_p, tiles_p, point_free_p, np.concatenate(orig_rows)


def solve_ba_tiles_sharded(
    params_t: BAParams,
    tiles: TileIndex,
    point_free_t,
    cam_free,
    options: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    axis=None,
    chunk_obs: int = CHUNK_OBS,
    while_block: int = 10,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
    impl: str = "xla",
):
    """Full tile-engine LM solve SPMD over the mesh.

    ``axis`` may be one axis name or a tuple (e.g. ("host", "chip")).
    Inputs are the ROW-SPACE arrays from tiles_from_scene /
    make_tile_rig_device; bucket rows must split evenly over the mesh (use
    :func:`shard_tile_rows`). Returns a BAResult in row space (caller
    unpermutes).

    Operational parity with the single-host drivers: ``while_block``-sized
    on-device ``lax.while_loop`` blocks with the wall-clock cap
    ``options.max_seconds`` (``src/sfm.cc:71``), per-block checkpointing
    (row-space ``.npz``; ``resume=True`` restarts from it), and per-block
    JSONL logging enforced on the host between blocks.
    """
    import time as _time

    from deeparc_tpu.parallel.sharded_ba import make_mesh
    from deeparc_tpu.residuals.reprojection import (
        flatten_camera, unflatten_camera,
    )
    from deeparc_tpu.solver import trust_region as tr_mod
    from deeparc_tpu.solver.ba import BAResult
    from deeparc_tpu.solver.tiles import TileState

    if mesh is None:
        mesh = make_mesh()
    if axis is None:
        axis = mesh.axis_names[0] if len(mesh.axis_names) == 1 else tuple(
            mesh.axis_names)
    n_shards = int(mesh.devices.size)

    params_p, tiles_p, point_free_p, orig_rows = shard_tile_rows(
        params_t, tiles, point_free_t, n_shards, chunk_obs)

    step = make_tile_step(options, params_p, chunk_obs, axis=axis,
                          impl=impl)
    spec = P(axis)

    buckets_in = tuple(
        TileBucket(
            cell=jnp.asarray(b.cell), xy0=jnp.asarray(b.xy0),
            xy1=jnp.asarray(b.xy1), mask=jnp.asarray(b.mask),
            loc=tuple(jnp.asarray(x) for x in b.loc),
        ) for b in tiles_p.buckets)

    def local_tiles(buckets, cells):
        return TileIndex(cells=cells, buckets=buckets,
                         row_of_point=jnp.zeros((1,), jnp.int32))

    def spmd_init(points, buckets, cells, cam_free, cam_params):
        t = local_tiles(buckets, cells)
        p = dataclasses.replace(cam_params, points=points)
        return init_tile_state(p, t, options, cam_free, axis=axis,
                               chunk_obs=chunk_obs)

    def spmd_block(state, point_free, buckets, cells, cam_free, k_stop):
        t = local_tiles(buckets, cells)
        return jax.lax.while_loop(
            lambda st: (st.status == 0) & (st.k < k_stop),
            lambda st: step(st, t, cam_free, point_free)[0],
            state,
        )

    bucket_specs = tuple(
        TileBucket(cell=spec, xy0=spec, xy1=spec, mask=spec,
                   loc=(spec, spec) if b.loc else ())
        for b in buckets_in)
    cell_specs = jax.tree.map(lambda _: P(), tiles_p.cells)
    state_spec = TileState(
        points=spec, cam_vec=P(), cost=P(),
        tr=tr_mod.TRState(radius=P(), decrease_factor=P()),
        k=P(), status=P(),
    )
    init_fn = jax.jit(shard_map(
        spmd_init, mesh=mesh,
        in_specs=(spec, bucket_specs, cell_specs, P(),
                  jax.tree.map(lambda _: P(), params_p)),
        out_specs=state_spec,
    ))
    block_fn = jax.jit(shard_map(
        spmd_block, mesh=mesh,
        in_specs=(state_spec, spec, bucket_specs, cell_specs, P(), P()),
        out_specs=state_spec,
    ))

    state = init_fn(params_p.points, buckets_in, tiles_p.cells, cam_free,
                    params_p)
    if resume and checkpoint_path:
        import os as _os

        if _os.path.exists(checkpoint_path):
            from deeparc_tpu.utils.checkpoint import load_solver_state

            ck_params, scal = load_solver_state(
                checkpoint_path, dtype=params_t.points.dtype)
            # checkpoint points are in the CALLER's row space; re-pad
            keep = orig_rows >= 0
            pts_pad = np.asarray(params_p.points).copy()
            pts_pad[keep] = np.asarray(ck_params.points)
            ck_p = dataclasses.replace(
                ck_params, points=jnp.asarray(pts_pad))
            state = init_fn(ck_p.points, buckets_in, tiles_p.cells,
                            cam_free, ck_p)
            state = state._replace(
                tr=tr_mod.TRState(
                    radius=jnp.asarray(scal["radius"],
                                       params_t.points.dtype),
                    decrease_factor=jnp.asarray(
                        scal["decrease_factor"], params_t.points.dtype)),
                k=jnp.asarray(scal["iteration"]),
            )

    def _row_space_params(st):
        from deeparc_tpu.parallel.multihost import gather_global

        keep = orig_rows >= 0
        pts_out = jnp.asarray(gather_global(st.points)[keep])
        out = unflatten_camera(st.cam_vec, params_t)
        return dataclasses.replace(out, points=pts_out)

    def _save(st, k):
        from deeparc_tpu.utils.checkpoint import save_solver_state

        if jax.process_index() != 0:
            return
        save_solver_state(
            checkpoint_path, _row_space_params(st),
            float(st.tr.radius), float(st.tr.decrease_factor),
            k, float(st.cost),
        )

    t0 = _time.time()
    k = int(state.k)
    while int(state.status) == 0 and k < options.max_iterations:
        if _time.time() - t0 > options.max_seconds:
            break
        k_stop = min(k + while_block, options.max_iterations)
        state = block_fn(state, point_free_p, buckets_in, tiles_p.cells,
                         cam_free, jnp.asarray(k_stop))
        k = int(state.k)
        if logger is not None:
            logger.log("lm_block", iter=k, cost=float(state.cost),
                       radius=float(state.tr.radius),
                       status=int(state.status))
        if checkpoint_path:
            _save(state, k)

    return BAResult(params=_row_space_params(state), cost=float(state.cost),
                    iterations=int(state.k), status=int(state.status))
