"""Distributed dense-grid bundle adjustment: points sharded over a mesh.

This is the flagship multi-chip path: the grid engine's plane-form
linearization (rig_planes.py) runs shard-locally on each device's slice of
the (N points x T cells) observation grid, and only the SMALL replicated
camera system crosses the interconnect:

  * grid rows (xy, mask), points, and point freeze masks are partitioned
    over the ``data`` mesh axis — every per-point quantity (H_pp, g_p, the
    E coupling rows, back-substitution) is shard-local, zero communication;
  * the reduced camera pieces (g_c (C,), H_cc (C,C), the Schur correction
    E^T B^-1 E (C,C) and rhs (C,)) are ``psum``-ed across the devices — a
    few hundred KB per LM iteration regardless of problem size;
  * LM trust-region control flow is replicated (cost/rho/radius derive from
    psum-reduced scalars), so the whole solve runs inside ONE
    ``shard_map`` + ``lax.while_loop`` computation with no host round-trips.

The step function itself is ``rig_grid.make_grid_step(axis=...)`` — the
exact single-chip code with its cross-point reductions routed through
psum/pmax, so distributed iterates match single-device iterates up to float
re-association (asserted in tests/test_dist.py on the virtual CPU mesh).

The reference has no distributed capability at all (SURVEY.md section 2.5);
this module is new capability mandated by BASELINE.json (>=75% scaling
efficiency at 2+ hosts).
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
from deeparc_tpu.solver.rig_grid import (
    GridIndex,
    GridState,
    init_grid_state,
    make_grid_step,
)


def _pad_rows(arr: jnp.ndarray, n_pad: int, fill=0.0) -> np.ndarray:
    arr = np.asarray(arr)
    if n_pad == 0:
        return arr
    pad = np.full((n_pad,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


def shard_grid_rows(params: BAParams, grid: GridIndex, point_free,
                    n_shards: int):
    """Host-side: pad N to a multiple of n_shards; return (params, grid,
    point_free) with point-major arrays padded (masked) for even sharding,
    plus the padded point count."""
    N = int(params.points.shape[0])
    n_local = -(-N // n_shards)
    n_pad = n_local * n_shards - N

    points = _pad_rows(params.points, n_pad)
    # padded points at z=1 so the projection chain stays finite
    if n_pad:
        points[N:, 2] = 1.0
    params_p = dataclasses.replace(params, points=jnp.asarray(points))
    grid_p = grid._replace(
        xy0=jnp.asarray(_pad_rows(grid.xy0, n_pad)),
        xy1=jnp.asarray(_pad_rows(grid.xy1, n_pad)),
        mask=jnp.asarray(_pad_rows(grid.mask, n_pad)),
        point_mask=jnp.asarray(_pad_rows(grid.point_mask, n_pad)),
    )
    point_free_p = jnp.asarray(_pad_rows(point_free, n_pad))
    return params_p, grid_p, point_free_p, N


def solve_ba_grid_sharded(
    params: BAParams,
    grid: GridIndex,
    free: BAParams,
    options: SolverOptions = SolverOptions(),
    mesh: Mesh | None = None,
    axis: str = "data",
    chunk_size: int = 8192,
    impl: str = "planes",
    while_block: int = 10,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
):
    """Full LM solve SPMD over the mesh's ``axis``. Returns a BAResult whose
    params are gathered back to host-global shapes (padding dropped).

    Operational parity with the single-host drivers (``solve_ba_grid``'s
    blocked mode): iterations run in ``while_block``-sized on-device
    ``lax.while_loop`` blocks; between blocks the host enforces the
    wall-clock cap ``options.max_seconds`` (reference: ``src/sfm.cc:71``),
    saves a solver-state checkpoint (``resume=True`` restarts from it), and
    emits a per-block JSONL log record — exactly the guarantees a
    multi-hour multi-host solve needs. The LM state stays sharded/replicated
    on device across blocks; only tiny replicated scalars hit the host.
    """
    import time as _time

    from deeparc_tpu.parallel.sharded_ba import make_mesh
    from deeparc_tpu.residuals.reprojection import flatten_camera
    from deeparc_tpu.solver import trust_region as tr_mod
    from deeparc_tpu.solver.ba import BAResult
    from deeparc_tpu.solver.rig_grid import _params_from

    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_shards = mesh.devices.size

    cam_free = flatten_camera(free)
    params_p, grid_p, point_free_p, N = shard_grid_rows(
        params, grid, free.points, n_shards)

    step = make_grid_step(options, params_p, chunk_size, impl=impl,
                          axis=axis)

    # point-major leaves shard over the axis; slot tables replicate
    sharded_fields = {"xy0", "xy1", "mask", "point_mask"}

    def local_grid(xy0, xy1, mask, point_mask, cam_tables):
        return GridIndex(xy0=xy0, xy1=xy1, mask=mask, point_mask=point_mask,
                         **{f: getattr(cam_tables["grid"], f)
                            for f in GridIndex._fields
                            if f not in sharded_fields})

    def spmd_init(points, xy0, xy1, mask, point_mask, cam_tables):
        g = local_grid(xy0, xy1, mask, point_mask, cam_tables)
        p = dataclasses.replace(cam_tables["params"], points=points)
        return init_grid_state(p, g, options, axis=axis, impl=impl)

    def spmd_block(state, xy0, xy1, mask, point_mask, point_free,
                   cam_tables, cam_free, k_stop):
        g = local_grid(xy0, xy1, mask, point_mask, cam_tables)
        return jax.lax.while_loop(
            lambda st: (st.status == 0) & (st.k < k_stop),
            lambda st: step(st, g, cam_free, point_free)[0],
            state,
        )

    rep_grid = grid_p._replace(
        xy0=jnp.zeros((0,) + grid_p.xy0.shape[1:], grid_p.xy0.dtype),
        xy1=jnp.zeros((0,) + grid_p.xy1.shape[1:], grid_p.xy1.dtype),
        mask=jnp.zeros((0,) + grid_p.mask.shape[1:], grid_p.mask.dtype),
        point_mask=jnp.zeros((0,), grid_p.point_mask.dtype),
    )
    cam_tables = {"grid": rep_grid, "params": params_p}

    state_spec = GridState(
        points=P(axis), cam_vec=P(), cost=P(),
        tr=tr_mod.TRState(radius=P(), decrease_factor=P()),
        k=P(), status=P(),
    )
    rep = jax.tree.map(lambda _: P(), cam_tables)
    init_fn = jax.jit(shard_map(
        spmd_init, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), rep),
        out_specs=state_spec,
    ))
    block_fn = jax.jit(shard_map(
        spmd_block, mesh=mesh,
        in_specs=(state_spec, P(axis), P(axis), P(axis), P(axis), P(axis),
                  rep, P(), P()),
        out_specs=state_spec,
    ))

    state = init_fn(params_p.points, grid_p.xy0, grid_p.xy1, grid_p.mask,
                    grid_p.point_mask, cam_tables)
    if resume and checkpoint_path:
        import os as _os

        if _os.path.exists(checkpoint_path):
            from deeparc_tpu.utils.checkpoint import load_solver_state

            ck_params, scal = load_solver_state(
                checkpoint_path, dtype=params.points.dtype)
            ck_p, ck_g, _, _ = shard_grid_rows(
                ck_params, grid, free.points, n_shards)
            st0 = init_fn(ck_p.points, ck_g.xy0, ck_g.xy1, ck_g.mask,
                          ck_g.point_mask,
                          {"grid": rep_grid, "params": ck_p})
            state = st0._replace(
                tr=tr_mod.TRState(
                    radius=jnp.asarray(scal["radius"], params.points.dtype),
                    decrease_factor=jnp.asarray(
                        scal["decrease_factor"], params.points.dtype)),
                k=jnp.asarray(scal["iteration"]),
            )

    def _save(st, k):
        from deeparc_tpu.parallel.multihost import gather_global
        from deeparc_tpu.utils.checkpoint import save_solver_state

        pts = jnp.asarray(gather_global(st.points)[:N])
        if jax.process_index() == 0:
            save_solver_state(
                checkpoint_path, _params_from(st.cam_vec, pts, params),
                float(st.tr.radius), float(st.tr.decrease_factor),
                k, float(st.cost),
            )

    t0 = _time.time()
    k = int(state.k)
    while int(state.status) == 0 and k < options.max_iterations:
        if _time.time() - t0 > options.max_seconds:
            break
        k_stop = min(k + while_block, options.max_iterations)
        state = block_fn(state, grid_p.xy0, grid_p.xy1, grid_p.mask,
                         grid_p.point_mask, point_free_p, cam_tables,
                         cam_free, jnp.asarray(k_stop))
        k = int(state.k)
        if logger is not None:
            logger.log("lm_block", iter=k, cost=float(state.cost),
                       radius=float(state.tr.radius),
                       status=int(state.status))
        if checkpoint_path:
            _save(state, k)

    out_params = _params_from(state.cam_vec, state.points[:N], params)
    return BAResult(
        params=out_params, cost=float(state.cost),
        iterations=int(state.k), status=int(state.status),
    )
