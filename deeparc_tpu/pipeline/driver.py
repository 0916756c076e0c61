"""The full SfM pipeline: hemisphere fit -> freeze solve -> filter loop.

Native re-design of the reference's ``main()`` (``src/sfm.cc:77-131``):

  1. load the scene, compute camera centers              (sfm.cc:83-86)
  2. fit the hemisphere prior by LM                      (sfm.cc:89-103)
  3. PLY snapshot of the initial scene                   (sfm.cc:110)
  4. points-only BA (freeze_camera=true, 100 iters)      (sfm.cc:111)
  5. filter outliers (threshold 5.0, hemisphere cut)     (sfm.cc:112)
  6. repeat { full BA; filter; snapshot } until the point
     count stops changing                                (sfm.cc:118-127)
  7. final PLY + refined .deeparc                        (sfm.cc:129-130)

Differences by design: paths/thresholds are options instead of #defines;
scene shrinkage is masking + bucketed compaction (bounded recompiles) instead
of pointer deletion; every solve is the jit-compiled Schur LM.

Checkpoint/resume (SURVEY.md section 5): a ``.deeparc`` written after any
filter round is itself a valid restart input, exactly as in the reference;
``run_pipeline`` additionally writes a small JSON sidecar with the solver
state per round.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from deeparc_tpu.config import PipelineOptions
from deeparc_tpu.geometry import camera_center_single, hemisphere_camera_centers
from deeparc_tpu.io.deeparc_format import DeepArcData, write_deeparc
from deeparc_tpu.io.ply import write_ply
from deeparc_tpu.pipeline.filtering import filter_outliers
from deeparc_tpu.residuals.reprojection import residuals
from deeparc_tpu.scene import Scene, compact, freeze_masks, from_deeparc, to_deeparc
from deeparc_tpu.solver.ba import solve_ba
from deeparc_tpu.solver.lm import fit_hemisphere


class PipelineResult(NamedTuple):
    scene: Scene
    hemisphere: np.ndarray       # [cx, cy, cz, r^2]
    filter_rounds: int
    final_cost: float
    final_rmse_px: float
    # per-round records: round, cost, iterations, status, obs/points alive,
    # cumulative elapsed_s (same payload as the state-sidecar checkpoints)
    rounds: tuple = ()


def scene_camera_centers(scene: Scene) -> jnp.ndarray:
    """All camera centers: hemisphere enumeration in shared mode
    (``getCameraCenter``, DeepArcManager.cc:501-518), else one per extrinsic."""
    rot = scene.params.ext_rot[:-1]
    trans = scene.params.ext_trans[:-1]
    if scene.meta.share_extrinsic:
        return hemisphere_camera_centers(
            rot, trans, scene.meta.arc_size, scene.meta.ring_size
        )
    return camera_center_single(rot, trans)


def _camera_composed_flags(scene: Scene) -> np.ndarray:
    """PLY camera coloring: composed (magenta) iff arc != 0 and ring != 0
    (DeepArcManager.cc:291-299)."""
    if not scene.meta.share_extrinsic:
        return np.zeros(scene.n_extrinsics, dtype=bool)
    A, R = scene.meta.arc_size, scene.meta.ring_size
    arc = np.repeat(np.arange(A), R)
    ring = np.tile(np.arange(R), A)
    return (arc != 0) & (ring != 0)


def _snapshot(scene: Scene, path: str) -> None:
    data = to_deeparc(scene)
    centers = np.asarray(scene_camera_centers(scene))
    write_ply(path, data.points, data.colors, centers, _camera_composed_flags(scene))


def _sync_grid_masks(scene: Scene, grid) -> Scene:
    """Reflect grid-space masks back onto the observation-list scene (for
    snapshots, export, and freeze-mask construction).

    The gather runs ON DEVICE: the dense (N, T) mask is ~300 MB at flagship
    scale, and pulling it to the host every round would dominate the loop."""
    cell = jnp.asarray(
        scene.meta.obs_arc.astype(np.int64) * scene.meta.ring_size
        + scene.meta.obs_ring.astype(np.int64), jnp.int32,
    )
    dtype = scene.params.points.dtype
    index = dataclasses.replace(
        scene.index,
        obs_mask=grid.mask[scene.index.obs_point, cell].astype(dtype),
        point_mask=grid.point_mask.astype(dtype),
    )
    return dataclasses.replace(scene, index=index)


def _write_sidecar(path, step, result, stats, t_start):
    """Build the per-round record; persist it when a path is given.
    Also returned to run_pipeline's ``rounds`` history."""
    sidecar = {
        "round": step, "cost": float(result.cost),
        "iterations": result.iterations, "status": result.status,
        "obs_alive": int(stats.obs_alive),
        "points_alive": int(stats.points_alive),
        "elapsed_s": time.time() - t_start,
    }
    if path:
        with open(path, "w") as f:
            json.dump(sidecar, f, indent=2)
    return sidecar


def rmse_px(scene: Scene) -> float:
    r = residuals(scene.params, scene.index)
    n = float(np.maximum(np.asarray(jnp.sum(scene.index.obs_mask)), 1.0))
    return float(np.sqrt(float(jnp.sum(r * r)) / n))


def run_pipeline(
    data: DeepArcData,
    options: PipelineOptions = PipelineOptions(),
    output_dir: Optional[str] = None,
    basename: str = "scene",
    dtype=jnp.float64,
    verbose: bool = True,
) -> PipelineResult:
    t_start = time.time()
    out = lambda name: os.path.join(output_dir, name) if output_dir else None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    scene = from_deeparc(data, dtype=dtype)
    rounds_log: list = []
    log = print if verbose else (lambda *a, **k: None)
    log(f"[deeparc] loaded: {scene.n_obs} obs, {scene.n_points} points, "
        f"{scene.n_extrinsics} extrinsics, {scene.n_intrinsics} intrinsics, "
        f"share_extrinsic={scene.meta.share_extrinsic}")

    # hemisphere prior fit (sfm.cc:86-103)
    centers = scene_camera_centers(scene)
    hemi = np.asarray(
        fit_hemisphere(centers, options.hemisphere_max_iterations)
    )
    log(f"[deeparc] hemisphere fit: center={hemi[:3]} r^2={hemi[3]:.6f}")

    if output_dir and options.write_snapshots:
        _snapshot(scene, out(f"{basename}_init.ply"))

    use_grid = options.engine in ("grid", "grid-sharded") or (
        options.engine == "auto" and scene.meta.share_extrinsic
    )
    # non-shared scenes default to the tile engine — the at-scale BAL path
    # (the reference drives them through the same loop, src/sfm.cc:77-131,
    # with the non-shared wiring of src/ParameterBlock.hh:52-55)
    use_tiles = not use_grid and (
        options.engine in ("tiles", "tiles-sharded")
        or options.engine == "auto"
    )
    # *-sharded engines: the SAME loop, solves SPMD over the mesh — the
    # reference's whole value is the loop (src/sfm.cc:118-127), so at scale
    # the loop itself must be distributed, not just one solve
    mesh = None
    if options.engine in ("grid-sharded", "tiles-sharded"):
        from deeparc_tpu.parallel import make_mesh

        mesh = make_mesh(options.devices)
        log(f"[deeparc] mesh: {mesh.devices.size} devices "
            f"({mesh.axis_names})")
    if use_grid:
        from deeparc_tpu.pipeline.filtering import FilterStats, filter_masks_grid
        from deeparc_tpu.solver.rig_grid import (
            grid_from_scene, resolve_grid_impl, solve_ba_grid,
        )

        grid_impl = resolve_grid_impl(options.impl)
        grid = grid_from_scene(scene)
        log(f"[deeparc] engine=grid ({grid.mask.shape[1]} cells, "
            f"{float(jnp.mean(grid.mask)) * 100:.1f}% grid density, "
            f"impl={grid_impl})")
        if mesh is not None:
            log("[deeparc] grid-sharded: the sharded step runs the "
                "unbanded plane path (no live-band prep across shards)")

        band_state: dict = {}    # band prep shared across filter rounds

        def run_solve(free):
            if mesh is not None:
                from deeparc_tpu.parallel.sharded_grid import (
                    solve_ba_grid_sharded,
                )

                return solve_ba_grid_sharded(
                    scene.params, grid, free, options.solver, mesh=mesh,
                    impl=grid_impl)
            res = solve_ba_grid(scene.params, grid, free, options.solver,
                                impl=grid_impl, band_reuse=band_state)
            return res

        def run_filter():
            mask, pmask = filter_masks_grid(
                scene.params, grid,
                jnp.asarray(hemi[:3], scene.params.points.dtype),
                float(hemi[3]), options.filter,
            )
            new_grid = grid._replace(mask=mask, point_mask=pmask)
            stats = FilterStats(
                obs_alive=jnp.sum(mask).astype(jnp.int32),
                points_alive=jnp.sum(pmask).astype(jnp.int32),
            )
            return new_grid, stats

        def point_free_of(free):
            return dataclasses.replace(
                free, points=free.points * grid.point_mask[:, None]
            )

        free_frozen = point_free_of(freeze_masks(scene, freeze_camera=True))
        result = run_solve(free_frozen)
        scene = dataclasses.replace(scene, params=result.params)
        log(f"[deeparc] freeze-camera solve: cost={float(result.cost):.6e} "
            f"iters={result.iterations}")
        grid, stats = run_filter()
        log(f"block: {int(stats.obs_alive)}")
        log(f"point3d: {int(stats.points_alive)}")
        scene = _sync_grid_masks(scene, grid)

        step = 0
        if output_dir and options.write_snapshots:
            _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
        old_points, current_points = -1, int(stats.points_alive)
        while current_points != old_points and step < options.max_filter_rounds:
            step += 1
            old_points = current_points
            free = point_free_of(freeze_masks(scene))
            result = run_solve(free)
            scene = dataclasses.replace(scene, params=result.params)
            grid, stats = run_filter()
            scene = _sync_grid_masks(scene, grid)
            current_points = int(stats.points_alive)
            log(f"block: {int(stats.obs_alive)}")
            log(f"point3d: {current_points}")
            if output_dir and options.write_snapshots:
                _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
            rounds_log.append(_write_sidecar(
                out(f"{basename}_state.json") if output_dir else None,
                step, result, stats, t_start))
    elif use_tiles:
        from deeparc_tpu.pipeline.filtering import (
            FilterStats, filter_masks_tiles,
        )
        from deeparc_tpu.residuals.reprojection import flatten_camera
        from deeparc_tpu.solver.tiles import (
            solve_tiles_prepared, tiles_from_scene, unpermute_points,
        )

        free0 = freeze_masks(scene)
        tiles, params_t, free_t, slot_src = tiles_from_scene(
            scene, free0, with_slot_src=True)
        tile_impl = options.impl
        if tile_impl in ("auto", "planes", "einsum"):   # grid-engine names
            tile_impl = "xla"
        elif tile_impl not in ("xla", "dual"):
            raise ValueError(f"unknown tile impl {tile_impl!r}: use "
                             "'auto', 'xla' or 'dual'")
        v_loc = [b.loc[1].shape[1] if b.loc else None for b in tiles.buckets]
        log(f"[deeparc] engine=tiles ({tiles.cells.cols.shape[0]} cells, "
            f"{len(tiles.buckets)} width buckets, v_local={v_loc}, "
            f"impl={tile_impl})")
        cam_free_full = flatten_camera(free0)
        cam_free_frozen = flatten_camera(
            freeze_masks(scene, freeze_camera=True))
        solve_cache: dict = {}
        params_rows = params_t

        def run_solve(tiles_cur, params_cur, cam_free, free_rows):
            if mesh is not None:
                from deeparc_tpu.parallel.sharded_tiles import (
                    solve_ba_tiles_sharded,
                )

                return solve_ba_tiles_sharded(
                    params_cur, tiles_cur, free_rows, cam_free,
                    options.solver, mesh=mesh, impl=tile_impl)
            return solve_tiles_prepared(
                params_cur, tiles_cur, free_rows, cam_free, options.solver,
                impl=tile_impl, unpermute=False, _cache=solve_cache,
            )

        def run_filter(tiles_cur, params_cur):
            masks, row_mask = filter_masks_tiles(
                params_cur.points, params_cur, tiles_cur,
                jnp.asarray(hemi[:3], params_cur.points.dtype),
                float(hemi[3]), options.filter,
            )
            new_buckets = tuple(
                b._replace(mask=m)
                for b, m in zip(tiles_cur.buckets, masks))
            stats = FilterStats(
                obs_alive=sum(jnp.sum(m) for m in masks).astype(jnp.int32),
                points_alive=jnp.sum(row_mask).astype(jnp.int32),
            )
            return tiles_cur._replace(buckets=new_buckets), row_mask, stats

        def sync_scene(scn, params_cur, tiles_cur, row_mask):
            pts = unpermute_points(params_cur.points, tiles)
            obs_mask = np.zeros(np.asarray(scn.index.obs_mask).shape)
            for b, src in zip(tiles_cur.buckets, slot_src):
                valid = src >= 0
                obs_mask[src[valid]] = np.asarray(b.mask)[valid]
            pmask = np.asarray(row_mask)[np.asarray(tiles.row_of_point)]
            index = dataclasses.replace(
                scn.index,
                obs_mask=jnp.asarray(obs_mask, pts.dtype),
                point_mask=jnp.asarray(pmask, pts.dtype),
            )
            new_params = dataclasses.replace(params_cur, points=pts)
            return dataclasses.replace(scn, params=new_params, index=index)

        result = run_solve(tiles, params_rows, cam_free_frozen, free_t)
        params_rows = result.params
        log(f"[deeparc] freeze-camera solve: cost={float(result.cost):.6e} "
            f"iters={result.iterations}")
        tiles_cur, row_mask, stats = run_filter(tiles, params_rows)
        free_rows = free_t * row_mask[:, None]
        log(f"block: {int(stats.obs_alive)}")
        log(f"point3d: {int(stats.points_alive)}")
        scene = sync_scene(scene, params_rows, tiles_cur, row_mask)

        step = 0
        if output_dir and options.write_snapshots:
            _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
        old_points, current_points = -1, int(stats.points_alive)
        while current_points != old_points and step < options.max_filter_rounds:
            step += 1
            old_points = current_points
            result = run_solve(tiles_cur, params_rows, cam_free_full,
                               free_rows)
            params_rows = result.params
            tiles_cur, row_mask, stats = run_filter(tiles_cur, params_rows)
            free_rows = free_t * row_mask[:, None]
            scene = sync_scene(scene, params_rows, tiles_cur, row_mask)
            current_points = int(stats.points_alive)
            log(f"block: {int(stats.obs_alive)}")
            log(f"point3d: {current_points}")
            if output_dir and options.write_snapshots:
                _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
            rounds_log.append(_write_sidecar(
                out(f"{basename}_state.json") if output_dir else None,
                step, result, stats, t_start))
    else:
        # points-only pre-solve (freeze_camera=true; sfm.cc:111)
        free_frozen = freeze_masks(scene, freeze_camera=True)
        result = solve_ba(scene.params, scene.index, free_frozen, options.solver)
        scene = dataclasses.replace(scene, params=result.params)
        log(f"[deeparc] freeze-camera solve: cost={float(result.cost):.6e} "
            f"iters={result.iterations}")

        scene, stats = filter_outliers(scene, hemi[:3], hemi[3], options.filter)
        log(f"block: {int(stats.obs_alive)}")
        log(f"point3d: {int(stats.points_alive)}")

        step = 0
        if output_dir and options.write_snapshots:
            _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))

        # solve-filter loop until the point count stabilizes (sfm.cc:118-127)
        old_points, current_points = -1, int(stats.points_alive)
        while current_points != old_points and step < options.max_filter_rounds:
            step += 1
            old_points = current_points
            scene = compact(scene, obs_bucket=1024, point_bucket=256)
            free = freeze_masks(scene)
            result = solve_ba(scene.params, scene.index, free, options.solver)
            scene = dataclasses.replace(scene, params=result.params)
            scene, stats = filter_outliers(scene, hemi[:3], hemi[3], options.filter)
            current_points = int(stats.points_alive)
            log(f"block: {int(stats.obs_alive)}")
            log(f"point3d: {current_points}")
            if output_dir and options.write_snapshots:
                _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
            rounds_log.append(_write_sidecar(
                out(f"{basename}_state.json") if output_dir else None,
                step, result, stats, t_start))

    log(f"TOTAL REPEAT: {step}")
    scene = compact(scene)
    if output_dir:
        _snapshot(scene, out(f"{basename}_clear.ply"))
        write_deeparc(to_deeparc(scene), out(f"{basename}_output.deeparc"))

    final_cost = 0.5 * float(
        jnp.sum(residuals(scene.params, scene.index) ** 2)
    )
    return PipelineResult(
        scene=scene,
        hemisphere=hemi,
        filter_rounds=step,
        final_cost=final_cost,
        final_rmse_px=rmse_px(scene),
        rounds=tuple(rounds_log),
    )
