"""Command-line interface for the SfM pipeline.

The reference has no CLI — input/output paths are compile-time #defines
(``src/sfm.cc:22-27``) and every threshold is a magic number (SURVEY.md
section 5). Here every one of those becomes a flag with the reference value
as its default.

Usage:
    python -m deeparc_tpu.pipeline.cli scene.deeparc --output-dir out/
    python -m deeparc_tpu.pipeline.cli --synthetic --n-points 2000 -o out/
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeparc-tpu",
        description="structure-from-motion bundle adjustment in JAX",
    )
    p.add_argument("input", nargs="?", help=".deeparc (or .bal) input file")
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--basename", default=None, help="output file prefix")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force a JAX platform; 'gpu' fails when no CUDA GPU "
                        "is found (default: leave as configured)")
    p.add_argument("--f32", action="store_true",
                   help="compute in float32 (default float64, the Ceres-parity dtype)")
    # solver (defaults: sfm.cc:66-73,111,121)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--max-seconds", type=float, default=3600.0)
    p.add_argument("--linear-solver", default="dense_schur",
                   choices=["dense_schur", "iterative_schur"])
    p.add_argument("--engine", default="auto",
                   choices=["auto", "grid", "indexed", "tiles",
                            "grid-sharded", "tiles-sharded"],
                   help="auto = dense grid engine for shared rigs, tile "
                        "engine for non-shared (BAL-style) scenes; indexed "
                        "= the observation-list engine (small problems); "
                        "*-sharded = the same pipeline with every solve "
                        "SPMD over the device mesh (--devices)")
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size for the *-sharded engines "
                        "(default: all visible devices)")
    p.add_argument("--impl", default="auto",
                   choices=["auto", "planes", "einsum", "xla", "dual"],
                   help="implementation inside the engine (auto = the "
                        "grid engine's plane path, banded when visibility "
                        "has locality; the tile engine's xla path)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans: fail loudly at the first NaN "
                        "(e.g. a point crossing z=0 in the perspective divide)")
    # filter (defaults: sfm.cc:112,122; DeepArcManager.cc:347-349,387)
    p.add_argument("--error-boundary", type=float, default=5.0)
    p.add_argument("--parity-inverted", action="store_true",
                   help="reproduce the reference's mse<threshold removal")
    p.add_argument("--no-hemisphere-cut", action="store_true")
    p.add_argument("--hemisphere-iterations", type=int, default=1000)
    p.add_argument("--no-snapshots", action="store_true")
    # synthetic problem generation (replaces the stripped reference datasets)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n-arc", type=int, default=5)
    p.add_argument("--n-ring", type=int, default=12)
    p.add_argument("--n-points", type=int, default=2000)
    p.add_argument("--pixel-noise", type=float, default=1.0)
    p.add_argument("--point-noise", type=float, default=0.05)
    p.add_argument("--random-points", action="store_true",
                   help="random structure init (teabottle_green_randompoint config)")
    p.add_argument("--occlusion-rings", type=int, default=None,
                   help="synthetic rig: self-occlusion window width in "
                        "turntable steps (realistic visibility; the grid "
                        "engine's live-band path exploits it)")
    p.add_argument("--visibility", type=float, default=1.0,
                   help="synthetic rig: random visibility thinning")
    p.add_argument("--seed", type=int, default=0)
    # incremental registration (BASELINE config 3: the *_bfs dataset path)
    p.add_argument("--incremental", action="store_true",
                   help="register cameras incrementally in BFS order over "
                        "the covisibility graph, bundle-adjusting per "
                        "batch (non-shared scenes add a pose-graph "
                        "refinement stage between batches)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="--incremental: cameras activated per batch "
                        "(default: one ring / C//8)")
    p.add_argument("--no-pose-graph", action="store_true",
                   help="--incremental: skip the pose-graph stage")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent XLA compilation cache "
                        "($JAX_COMPILATION_CACHE_DIR, else .jax_cache/ in "
                        "the checkout); first-compile time dominates "
                        "time-to-first-result on small scenes, so the CLI "
                        "caches compiled executables by default")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.platform is not None:
        from deeparc_tpu.utils.platform import PlatformError, select_platform

        try:
            select_platform(args.platform)
        except PlatformError as e:
            print(f"error: --platform {args.platform}: {e}", file=sys.stderr)
            return 2
    if not args.no_compile_cache:
        # persistent compile cache: the pipeline re-runs identical step
        # HLO across rounds and across invocations
        from deeparc_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    if args.debug_nans:
        from deeparc_tpu.utils.debug import set_nan_debugging

        set_nan_debugging(True)

    import jax.numpy as jnp

    from deeparc_tpu.config import FilterOptions, PipelineOptions, SolverOptions
    from deeparc_tpu.io.native import read_bal_fast as read_bal
    from deeparc_tpu.io.native import read_deeparc_fast as read_deeparc
    from deeparc_tpu.io.synthetic import make_hemisphere_rig
    from deeparc_tpu.pipeline.driver import run_pipeline

    if args.synthetic:
        rig = make_hemisphere_rig(
            n_arc=args.n_arc, n_ring=args.n_ring, n_points=args.n_points,
            pixel_noise=args.pixel_noise, point_noise=args.point_noise,
            random_points=args.random_points, seed=args.seed,
            occlusion_rings=args.occlusion_rings,
            visibility=args.visibility,
        )
        data = rig.data
        basename = args.basename or "synthetic"
    elif args.input:
        if args.input.endswith(".bal") or args.input.endswith(".bal.gz"):
            data = read_bal(args.input)
        else:
            data = read_deeparc(args.input)
        import os

        basename = args.basename or os.path.splitext(
            os.path.basename(args.input)
        )[0]
    else:
        print("error: provide an input file or --synthetic", file=sys.stderr)
        return 2

    options = PipelineOptions(
        solver=SolverOptions(
            max_iterations=args.max_iterations,
            max_seconds=args.max_seconds,
            linear_solver=args.linear_solver,
            progress_to_stdout=not args.quiet,
        ),
        filter=FilterOptions(
            error_boundary=args.error_boundary,
            parity_inverted=args.parity_inverted,
            hemisphere_cut=not args.no_hemisphere_cut,
        ),
        hemisphere_max_iterations=args.hemisphere_iterations,
        write_snapshots=not args.no_snapshots,
        engine=args.engine,
        impl=args.impl,
        devices=args.devices,
    )
    dtype = jnp.float32 if args.f32 else jnp.float64
    if args.incremental:
        from deeparc_tpu.pipeline.incremental import run_incremental

        inc = run_incremental(
            data, options, batch_size=args.batch_size, dtype=dtype,
            verbose=not args.quiet, pose_graph=not args.no_pose_graph,
        )
        if args.output_dir:
            import os

            from deeparc_tpu.io.deeparc_format import write_deeparc
            from deeparc_tpu.scene import to_deeparc

            os.makedirs(args.output_dir, exist_ok=True)
            write_deeparc(to_deeparc(inc.scene), os.path.join(
                args.output_dir, f"{basename}_incremental.deeparc"))
        print(
            f"[deeparc] incremental done: batches={inc.batches} "
            f"cost={inc.final_cost:.6e} rmse={inc.final_rmse_px:.4f}px"
        )
        return 0
    result = run_pipeline(
        data, options, output_dir=args.output_dir, basename=basename,
        dtype=dtype, verbose=not args.quiet,
    )
    print(
        f"[deeparc] done: rounds={result.filter_rounds} "
        f"cost={result.final_cost:.6e} rmse={result.final_rmse_px:.4f}px"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
