#!/usr/bin/env python
"""Smoke run of the whole system on one CUDA GPU (the quickest proof that it
still starts and is right on the card).

    python chip_smoke.py               # every one-card phase below
    python chip_smoke.py --four-cards  # only the sharded path on 4 cards

One process drives the card. Phases, each printing its compile and steady
seconds (compile = lowering + XLA compile or compile-cache load, from
``jax.monitoring``) and its checks; any failure raises and the script
exits non-zero:

  band_parity      the live-band linearization against the unbanded plane
                   path at flagship widths (400k points, 192 cells),
                   float32, relative Frobenius errors
  grid_step        one LM step of the grid engine, GPU float32 against CPU
                   float64, 8192 points
  tile_step        one LM step of the tile engine, GPU float32 against CPU
                   float64, and the steady time of one XLA tile step at BAL
                   scale (1M points, 2000 cameras)
  flagship         the full pipeline (run_pipeline, engine auto: the
                   banded plane path) on the flagship rig, twice (cold,
                   then with the in-process caches and the persistent
                   compile cache warm): RMSE <= 1.5 px, the same filter
                   rounds and points alive both times
  tiles_pipeline   the full pipeline on a BAL-shaped non-shared scene
                   (engine auto picks the tile engine), 250k points: the
                   host-side tile build runs once per filter round
  cli_golden       the CLI with --platform gpu on the golden fixture

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
With no GPU, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP = dict(n_arc=8, n_ring=24, n_points=400_000, occlusion_rings=6,
                visibility=10.0 / 48, pixel_noise=1.0, point_noise=0.02,
                seed=0)
BAL = dict(n_cameras=2000, n_points=1_000_000, track_length=8, window=128)

# parity bounds (relative Frobenius errors). float32 sums of up to 4M terms
# in another order: 1e-5 for per-point quantities, cost and E; 1e-4 for the
# slot Gram sums. f32-vs-f64 steps: the f32 Schur solve loses a few digits
# to the conditioning of the reduced camera system (tiles: PCG in f32).
BAND_BOUNDS = dict(cost=1e-5, g_p=1e-5, hpp=1e-5, g_c=1e-4, hcc=1e-4,
                   E=1e-5)
STEP_BOUNDS = dict(grid_cost=1e-5, grid_step=5e-3,
                   tile_cost=1e-5, tile_step=1e-2)
RMSE_MAX_PX = 1.5
SHARDED_COST_RTOL = 1e-4


class CheckFailed(AssertionError):
    """A smoke check did not hold."""


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _check(name: str, errs: dict, bounds: dict) -> None:
    log(f"[{name}] errors " + " ".join(
        f"{k}={v:.3e}(<= {bounds[k]:.0e})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
    if bad:
        raise CheckFailed(f"{name}: out of bounds {bad}")


_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0, False]


def compile_seconds() -> float:
    """Seconds this process has spent lowering and compiling (or loading
    compiled executables from the persistent cache) so far."""
    if not _compile_s[1]:
        import jax.monitoring

        def on(name, secs, **_):
            if name in _COMPILE_EVENTS:
                _compile_s[0] += secs

        jax.monitoring.register_event_duration_secs_listener(on)
        _compile_s[1] = True
    return _compile_s[0]


def _timed(fn, *args, reps: int = 5):
    """(first-call seconds incl. compile, steady ms per call, output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return first, (time.perf_counter() - t0) / reps * 1e3, out


def flagship_grid(n_points: int, dtype=None, **over):
    """The flagship rig's device-side problem: (params, grid)."""
    import jax.numpy as jnp

    from deeparc_tpu.io.synthetic import make_grid_rig_device

    cfg = dict(FLAGSHIP, n_points=n_points, **over)
    params, grid, _ = make_grid_rig_device(dtype=dtype or jnp.float32, **cfg)
    return params, grid


def phase_band_parity(n_points: int = FLAGSHIP["n_points"]) -> dict:
    """The live-band linearization against the unbanded plane path on the
    band-prepared flagship (both plain XLA, float32, intrinsics frozen):
    band prep may skip only dead slots."""
    import jax
    import jax.numpy as jnp

    from deeparc_tpu.solver.rig_band import band_grid
    from deeparc_tpu.solver.rig_grid import assemble_grid_system, slot_params

    params, grid = flagship_grid(n_points)
    prep = band_grid(grid)
    if prep is None:
        raise CheckFailed("band prep found no locality on the flagship rig")
    g = prep.grid
    pts = params.points[prep.perm]
    pf = jnp.ones_like(pts)
    T = g.mask.shape[1]
    R = g.onehot_outer.shape[1]
    K = g.onehot_intr.shape[1]
    cam_free = jnp.concatenate([jnp.ones((6 * R,), pts.dtype),
                                jnp.zeros((6 * K,), pts.dtype)])
    (w_lin, _), (b_lin, _) = prep.widths

    def banded(p, gr):
        return assemble_grid_system(
            p, slot_params(params, gr), gr, cam_free, pf, impl="planes",
            band_width=w_lin, band_block=b_lin, band_intr_frozen=True)

    def unbanded(p, gr):
        return assemble_grid_system(
            p, slot_params(params, gr), gr, cam_free, pf, impl="planes")

    c0 = compile_seconds()
    b_first, b_ms, got = _timed(jax.jit(banded), pts, g)
    c1 = compile_seconds()
    u_first, u_ms, ref = _timed(jax.jit(unbanded), pts, g._replace(band=()))
    c2 = compile_seconds()
    errs = {k: _rel(getattr(got, k), getattr(ref, k))
            for k in ("cost", "g_p", "hpp", "g_c", "hcc")}
    errs["E"] = _rel(got.E, ref.E[..., :6 * R])
    log(f"[band_parity] {n_points} points, {T} cells, lin groups "
        f"{[w for w, _, _ in prep.lin_groups]}: banded linearize "
        f"compile+first {b_first:.3f} s (compile {c1 - c0:.3f} s) steady "
        f"{b_ms:.3f} ms; unbanded compile+first {u_first:.3f} s (compile "
        f"{c2 - c1:.3f} s) steady {u_ms:.3f} ms")
    _check("band_parity", errs, BAND_BOUNDS)
    return dict(banded_ms=b_ms, unbanded_ms=u_ms, banded_first_s=b_first,
                unbanded_first_s=u_first, errors=errs)


def _to_device(tree, dtype, device):
    """Cast a pytree's floating leaves to ``dtype`` and place it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def cast(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(dtype)
        return jax.device_put(jnp.asarray(x), device)

    return jax.tree.map(cast, tree)


def _grid_free(params):
    """Points and cameras free (gauge and identity rows fixed), intrinsics
    free too, so the step carries all 18 camera parameters per slot."""
    import jax.numpy as jnp

    n_ext = params.ext_rot.shape[0]
    one = lambda a: jnp.ones_like(a)
    ext = one(params.ext_rot).at[0].set(0.0).at[n_ext - 1].set(0.0)
    return dataclasses.replace(
        params, points=one(params.points), ext_rot=ext, ext_trans=ext,
        center=one(params.center), focal=one(params.focal),
        dist=one(params.dist))


def _step_delta(res, params):
    import numpy as np

    from deeparc_tpu.residuals.reprojection import flatten_camera

    return np.concatenate([
        np.asarray(res.params.points, np.float64).ravel()
        - np.asarray(params.points, np.float64).ravel(),
        np.asarray(flatten_camera(res.params), np.float64)
        - np.asarray(flatten_camera(params), np.float64)])


def phase_grid_step(n_points: int = 8192) -> dict:
    """One grid LM step (engine default: the banded plane path): default
    device in float32 against the CPU in float64, same data."""
    import jax
    import jax.numpy as jnp

    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import solve_ba_grid

    opts = SolverOptions(max_iterations=1, min_relative_decrease=-1.0)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        p64, g64 = flagship_grid(n_points, jnp.float64)
        free64 = _grid_free(p64)
        t0 = time.perf_counter()
        r64 = solve_ba_grid(p64, g64, free64, opts)
        cpu_s = time.perf_counter() - t0
        d64 = _step_delta(r64, p64)
    dev = jax.devices()[0]
    p32, g32, free32 = _to_device((p64, g64, free64), jnp.float32, dev)
    t0 = time.perf_counter()
    r32 = solve_ba_grid(p32, g32, free32, opts)
    dev_s = time.perf_counter() - t0
    errs = dict(grid_cost=abs(r32.cost - r64.cost) / abs(r64.cost),
                grid_step=_rel(_step_delta(r32, p32), d64))
    log(f"[grid_step] {n_points} points: cost f32 "
        f"{r32.cost:.9e} f64 {r64.cost:.9e}; {dev.platform} compile+step "
        f"{dev_s:.3f} s, cpu f64 {cpu_s:.3f} s")
    _check("grid_step", {k: errs[k] for k in ("grid_cost", "grid_step")},
           STEP_BOUNDS)
    return errs


def _bal_tiles(n_points, n_cameras, dtype):
    import jax.numpy as jnp

    from deeparc_tpu.io.synthetic import make_bal_tile_device

    params, tiles, _, cam_free = make_bal_tile_device(
        n_cameras=n_cameras, n_points=n_points,
        track_length=BAL["track_length"], window=BAL["window"],
        pixel_noise=1.0, point_noise=0.02, seed=0, dtype=dtype)
    n_ext = params.ext_rot.shape[0]
    cam_free = cam_free.at[:6].set(0.0)
    cam_free = cam_free.at[6 * (n_ext - 1): 6 * n_ext].set(0.0)
    cam_free = cam_free.at[6 * n_ext:].set(0.0)
    return params, tiles, cam_free, jnp.ones_like(params.points)


def phase_tile_step(n_points: int = 8192, n_cameras: int = 256,
                    bal_points: int = BAL["n_points"],
                    bal_cameras: int = BAL["n_cameras"]) -> dict:
    """One tile LM step, default device f32 vs CPU f64; then the steady
    time of one XLA tile step (30 PCG iterations) at BAL scale."""
    import jax
    import jax.numpy as jnp

    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.tiles import (
        init_tile_state, make_tile_step, solve_tiles_prepared,
    )

    opts = SolverOptions(linear_solver="iterative_schur", max_iterations=1,
                         min_relative_decrease=-1.0)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        args64 = _bal_tiles(n_points, n_cameras, jnp.float64)
        p64, t64, cf64, pf64 = args64
        r64 = solve_tiles_prepared(p64, t64, pf64, cf64, opts,
                                   unpermute=False)
        d64 = _step_delta(r64, p64)
    p32, t32, cf32, pf32 = _to_device(args64, jnp.float32, jax.devices()[0])
    r32 = solve_tiles_prepared(p32, t32, pf32, cf32, opts, unpermute=False)
    errs = dict(tile_cost=abs(r32.cost - r64.cost) / abs(r64.cost),
                tile_step=_rel(_step_delta(r32, p32), d64))
    log(f"[tile_step] {n_points} points, {n_cameras} cameras: cost f32 "
        f"{r32.cost:.9e} f64 {r64.cost:.9e}")
    _check("tile_step", errs, STEP_BOUNDS)

    params, tiles, cam_free, point_free = _bal_tiles(
        bal_points, bal_cameras, jnp.float32)
    bench = SolverOptions(linear_solver="iterative_schur",
                          cg_max_iterations=30, cg_tolerance=0.0,
                          min_relative_decrease=-1.0)
    step = make_tile_step(bench, params, impl="xla")
    run = jax.jit(lambda s: step(s, tiles, cam_free, point_free)[0])
    state = init_tile_state(params, tiles, bench, cam_free)
    first, ms, _ = _timed(run, state, reps=5)
    n_obs = int(sum(float(jnp.sum(b.mask)) for b in tiles.buckets))
    log(f"[tile_step] XLA tile LM step, {bal_points} points, {bal_cameras}"
        f" cameras, {n_obs} obs, 30 PCG iterations: compile+first "
        f"{first:.3f} s, steady {ms:.3f} ms")
    return dict(errs, tile_step_ms=ms, tile_step_first_s=first)


def _pipeline(data, impl: str, engine: str = "auto", devices=None,
              max_iterations: int = 100, max_filter_rounds: int = 100):
    import jax.numpy as jnp

    from deeparc_tpu.config import FilterOptions, PipelineOptions
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.pipeline.driver import run_pipeline

    opts = PipelineOptions(
        solver=SolverOptions(max_iterations=max_iterations),
        filter=FilterOptions(), write_snapshots=False, engine=engine,
        impl=impl, devices=devices, max_filter_rounds=max_filter_rounds)
    t0 = time.perf_counter()
    res = run_pipeline(data, opts, output_dir=None, dtype=jnp.float32,
                       verbose=False)
    return res, time.perf_counter() - t0


def _summary(res) -> dict:
    return dict(final_cost=res.final_cost, final_rmse_px=res.final_rmse_px,
                filter_rounds=res.filter_rounds,
                points_alive=int(res.scene.n_points))


def flagship_rig(n_points: int):
    from deeparc_tpu.io.synthetic import make_hemisphere_rig

    cfg = dict(FLAGSHIP, n_points=n_points)
    return make_hemisphere_rig(**cfg).data


def phase_flagship(n_points: int = FLAGSHIP["n_points"]) -> dict:
    """The flagship pipeline (engine auto: the banded plane path) twice in
    one process: cold, then warm (in-process caches and the persistent
    compile cache filled). RMSE at the noise floor; both runs agree."""
    t0 = time.perf_counter()
    data = flagship_rig(n_points)
    gen_s = time.perf_counter() - t0
    runs = []
    for name in ("cold", "warm"):
        c0 = compile_seconds()
        res, wall = _pipeline(data, "auto")
        runs.append(dict(_summary(res), wall_s=wall,
                         compile_s=compile_seconds() - c0))
        log(f"[flagship] {name}: {n_points} points, {data.n_obs} obs (gen "
            f"{gen_s:.3f} s): {runs[-1]}")
    cold, warm = runs
    if not cold["final_rmse_px"] <= RMSE_MAX_PX:
        raise CheckFailed(f"flagship RMSE {cold['final_rmse_px']} > "
                          f"{RMSE_MAX_PX}")
    for k in ("filter_rounds", "points_alive"):
        if cold[k] != warm[k]:
            raise CheckFailed(f"flagship {k}: cold {cold[k]} != warm "
                              f"{warm[k]}")
    return dict(cold, warm=warm, gen_s=gen_s)


def bal_scene(n_points: int, n_cameras: int = BAL["n_cameras"]):
    from deeparc_tpu.io.synthetic import make_bal_windowed_host

    return make_bal_windowed_host(
        n_cameras=n_cameras, n_points=n_points,
        track_length=BAL["track_length"], window=BAL["window"], n_hubs=0,
        hub_frac=0.0, seed=0)


def phase_tiles_pipeline(n_points: int = 250_000,
                         n_cameras: int = BAL["n_cameras"]) -> dict:
    """The pipeline on a BAL-shaped non-shared scene (tile engine). The
    point count is cut from the BAL shape's 1M: the host rebuilds the tile
    layout every filter round, and at 1M five rounds take minutes."""
    t0 = time.perf_counter()
    data = bal_scene(n_points, n_cameras)
    gen_s = time.perf_counter() - t0
    res, wall = _pipeline(data, "auto")
    s = _summary(res)
    log(f"[tiles_pipeline] {n_points} points, {n_cameras} cameras, "
        f"{data.n_obs} obs (gen {gen_s:.3f} s): {wall:.3f} s {s}")
    if not s["final_rmse_px"] <= RMSE_MAX_PX:
        raise CheckFailed(f"tiles RMSE {s['final_rmse_px']} > {RMSE_MAX_PX}")
    return dict(s, wall_s=wall, gen_s=gen_s)


def phase_cli_golden(platform: str = "gpu") -> dict:
    """The CLI, in this process, on the hand-authored golden fixture."""
    from deeparc_tpu.pipeline.cli import main as cli_main

    fixture = os.path.join(HERE, "tests", "fixtures",
                           "golden_nonshared.deeparc")
    t0 = time.perf_counter()
    rc = cli_main([fixture, "--platform", platform, "--no-snapshots",
                   "--quiet"])
    wall = time.perf_counter() - t0
    log(f"[cli_golden] rc={rc} {wall:.3f} s")
    if rc != 0:
        raise CheckFailed(f"CLI exited {rc}")
    return dict(wall_s=wall)


def phase_four_cards(n_points: int = FLAGSHIP["n_points"],
                     bal_points: int = 200_000, n_dev: int = 4) -> dict:
    """Sharded grid pipeline and a short sharded tile solve over ``n_dev``
    devices, each against the same solve on one device. First a sharded
    grid solve alone: its point array must be split over all devices, and
    device memory with it."""
    import jax
    import jax.numpy as jnp

    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.parallel import make_mesh
    from deeparc_tpu.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu.scene import freeze_masks, from_deeparc
    from deeparc_tpu.solver.rig_grid import grid_from_scene

    if len(jax.devices()) < n_dev:
        raise CheckFailed(f"--four-cards needs {n_dev} devices, found "
                          f"{len(jax.devices())}")
    data = flagship_rig(n_points)
    scene = from_deeparc(data, dtype=jnp.float32)
    res = solve_ba_grid_sharded(scene.params, grid_from_scene(scene),
                                freeze_masks(scene),
                                SolverOptions(max_iterations=2),
                                mesh=make_mesh(n_dev))
    pts = res.params.points
    shards = {s.device.id: s.data.shape for s in pts.addressable_shards}
    # memory_stats is None on the CPU backend (rehearsals)
    stats = [dv.memory_stats() for dv in jax.devices()[:n_dev]]
    peaks = [st["peak_bytes_in_use"] for st in stats if st]
    log(f"[four_cards] sharded points {pts.shape}: {pts.sharding}; "
        f"shards {shards}; per-device peak bytes {peaks or 'n/a'}")
    if len(pts.sharding.device_set) != n_dev or len(shards) != n_dev or any(
            shape[0] >= pts.shape[0] for shape in shards.values()):
        raise CheckFailed(f"points are not split over {n_dev} devices")
    # device 0 also held the whole unsharded scene before it was split,
    # so its peak is higher; every other device must carry a like share
    if peaks and (min(peaks) < 0.25 * max(peaks)
                  or min(peaks[1:]) < 0.9 * max(peaks[1:])):
        raise CheckFailed(f"device memory not spread: peaks {peaks}")
    del res, pts, scene
    out = dict(shards=shards, peaks=peaks)

    for d in (1, n_dev):
        res, wall = _pipeline(data, "auto", engine="grid-sharded", devices=d)
        out[f"grid_{d}"] = dict(_summary(res), wall_s=wall)
        log(f"[four_cards] grid-sharded pipeline on {d} device(s): "
            f"{wall:.3f} s {out[f'grid_{d}']}")
    one, many = out["grid_1"], out[f"grid_{n_dev}"]
    err = abs(many["final_cost"] - one["final_cost"]) / one["final_cost"]
    out["grid_cost_rel"] = err
    if not err <= SHARDED_COST_RTOL or any(
            one[k] != many[k] for k in ("filter_rounds", "points_alive")):
        raise CheckFailed(f"grid-sharded differs from one device: rel "
                          f"{err:.3e}, {one} vs {many}")

    bal = bal_scene(bal_points)
    for d in (1, n_dev):
        res, wall = _pipeline(bal, "auto", engine="tiles-sharded",
                              devices=d, max_iterations=5,
                              max_filter_rounds=1)
        out[f"tiles_{d}"] = dict(_summary(res), wall_s=wall)
        log(f"[four_cards] tiles-sharded, 5 LM iterations + 1 filter round"
            f" on {d} device(s): {wall:.3f} s {out[f'tiles_{d}']}")
    one, many = out["tiles_1"], out[f"tiles_{n_dev}"]
    err = abs(many["final_cost"] - one["final_cost"]) / one["final_cost"]
    out["tiles_cost_rel"] = err
    log(f"[four_cards] relative cost error, {n_dev} devices vs 1: grid "
        f"{out['grid_cost_rel']:.3e}, tiles {err:.3e} (<= "
        f"{SHARDED_COST_RTOL:.0e})")
    if not err <= SHARDED_COST_RTOL:
        raise CheckFailed(f"tiles-sharded differs from one device: {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on 4 cards and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"error: no GPU (JAX found {jax.devices()[0].platform})",
              file=sys.stderr)
        return 1
    from deeparc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    compile_seconds()            # start counting before the first compile
    dev = jax.devices()[0]
    log(f"[smoke] {dev.device_kind} x{len(jax.devices())}, jax "
        f"{jax.__version__}, compile cache {cache}")
    t_all = time.perf_counter()
    phases = ((phase_four_cards,) if args.four_cards else (
        phase_band_parity, phase_grid_step, phase_tile_step, phase_flagship,
        phase_tiles_pipeline, phase_cli_golden))
    for phase in phases:
        t0, c0 = time.perf_counter(), compile_seconds()
        phase()
        log(f"[smoke] {phase.__name__[6:]} done in "
            f"{time.perf_counter() - t0:.3f} s, of which compile "
            f"{compile_seconds() - c0:.3f} s")
    log(f"[smoke] all phases {time.perf_counter() - t_all:.3f} s, compile "
        f"{compile_seconds():.3f} s")
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
