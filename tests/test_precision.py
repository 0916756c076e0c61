"""Every float32 matrix product of the LM steps asks for full precision.

On a GPU a float32 ``dot_general`` at default precision may run in TF32
(about three decimal digits), which would round the one-hot selections,
the slot Gram sums and the Schur complement. The steps are lowered to
StableHLO here on the CPU; each float32 ``dot_general`` must carry
``precision = [HIGHEST, HIGHEST]`` (or an explicit algorithm).
"""

import jax
import jax.numpy as jnp
import pytest

from deeparc_tpu.config import SolverOptions


def _assert_highest(text: str) -> None:
    dots = [line.strip() for line in text.splitlines()
            if "stablehlo.dot_general" in line and "xf32>" in line]
    assert dots, "the step lowered no float32 dot_general"
    loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d
             and "algorithm" not in d]
    assert not loose, f"{len(loose)} of {len(dots)} at default: {loose[:2]}"


@pytest.fixture(scope="module")
def grid_problem():
    from deeparc_tpu.io.synthetic import make_grid_rig_device
    from deeparc_tpu.solver.rig_band import band_grid

    params, grid, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=300, occlusion_rings=4, visibility=0.9,
        pixel_noise=0.8, point_noise=0.02, seed=7, dtype=jnp.float32)
    return params, grid, band_grid(grid, block_np=64, cost_block_np=128)


@pytest.mark.parametrize("impl,banded", [
    ("planes", False), ("planes", True), ("einsum", False),
])
def test_grid_step_products_are_highest(grid_problem, impl, banded):
    import dataclasses

    from deeparc_tpu.solver.rig_grid import init_grid_state, make_grid_step

    params, grid, prep = grid_problem
    bw = bb = (0, 0)
    if banded:
        grid, bw, bb = prep.grid, *prep.widths
        params = dataclasses.replace(params, points=params.points[prep.perm])
    C = 6 * (params.ext_rot.shape[0] + params.center.shape[0])
    cam_free = jnp.ones((C,), jnp.float32).at[:6].set(0.0)
    point_free = jnp.ones_like(params.points)
    options = SolverOptions(linear_solver="dense_schur")
    step = make_grid_step(options, params, chunk_size=64, impl=impl,
                          band_widths=bw, band_blocks=bb,
                          band_intr_frozen=banded)
    state = init_grid_state(params, grid, options, impl=impl,
                            band_widths=bw, band_blocks=bb)
    _assert_highest(jax.jit(step).lower(state, grid, cam_free,
                                        point_free).as_text())


def test_fused_trial_step_products_are_highest(grid_problem):
    from deeparc_tpu.solver.rig_grid import (
        init_grid_state_fused, make_grid_step,
    )

    params, grid, _ = grid_problem
    C = 6 * (params.ext_rot.shape[0] + params.center.shape[0])
    cam_free = jnp.ones((C,), jnp.float32).at[:6].set(0.0)
    point_free = jnp.ones_like(params.points)
    options = SolverOptions(linear_solver="dense_schur")
    step = make_grid_step(options, params, chunk_size=64, fuse_trial=True)
    state = init_grid_state_fused(params, grid, options, cam_free,
                                  point_free, chunk_size=64)
    _assert_highest(jax.jit(step).lower(state, grid, cam_free,
                                        point_free).as_text())


@pytest.mark.parametrize("impl", ["xla", "dual"])
def test_tile_step_products_are_highest(impl):
    from deeparc_tpu.io.synthetic import make_bal_tile_device
    from deeparc_tpu.solver.tiles import (
        init_tile_state, make_tile_step, with_cam_layout,
    )

    params, tiles, _, cam_free = make_bal_tile_device(
        n_cameras=32, n_points=512, track_length=8, window=16, seed=0,
        dtype=jnp.float32)
    if impl == "dual":
        tiles = with_cam_layout(tiles)
    cam_free = cam_free.at[:6].set(0.0)
    options = SolverOptions(linear_solver="iterative_schur",
                            cg_max_iterations=5)
    step = make_tile_step(options, params, impl=impl)
    state = init_tile_state(params, tiles, options, cam_free)
    point_free = jnp.ones_like(params.points)
    _assert_highest(jax.jit(step).lower(state, tiles, cam_free,
                                        point_free).as_text())
