"""The plain paths that replaced the Pallas kernels, plus the dispatch.

The grid engine has no hand-written kernel: its linearization and cost
pass are plain XLA over (N, T) planes or over each point tile's live band
(``rig_planes.linearize_banded`` / ``cost_banded``). Here the banded
linearize runs with the whole grid as one band from cell 0, at two point
tile sizes (padding inside and across tiles), and every output must match
``rig_planes.linearize_planes`` bit-for-tolerance. The dispatch names the
implementations that exist and raises for any other, so asking for a
kernel never quietly runs something else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.scene import freeze_masks, from_deeparc
from deeparc_tpu.solver.rig_grid import (
    grid_cost, grid_from_scene, resolve_grid_impl, slot_params,
)
from deeparc_tpu.solver.rig_planes import (
    cost_banded, cost_planes, linearize_banded, linearize_planes,
)


@pytest.fixture(scope="module", params=[
    dict(focal_size=1, dist_size=0),
    dict(focal_size=2, dist_size=2),
])
def problem(request):
    rig = make_hemisphere_rig(
        n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5, point_noise=0.04,
        visibility=0.8, seed=31, **request.param,
    )
    scene = from_deeparc(rig.data)
    grid = grid_from_scene(scene)
    free = freeze_masks(scene)
    return scene, grid, free


def _free_tables(scene, grid, free):
    from deeparc_tpu.residuals.reprojection import flatten_camera

    cam_free = flatten_camera(free)
    R_rows = grid.onehot_outer.shape[1]
    K = grid.onehot_intr.shape[1]
    rows = cam_free[: 6 * R_rows].reshape(R_rows, 6)
    intr = cam_free[6 * R_rows:].reshape(K, 6)
    return rows[grid.slot_outer], rows[grid.slot_inner], intr[grid.slot_intr]


def _one_band(pts, grid, block_np):
    """(starts, width) of one band of all cells from cell 0 (no band prep)."""
    T = grid.mask.shape[1]
    n_tiles = -(-pts.shape[0] // block_np)
    return jnp.zeros((n_tiles,), jnp.int32), -(-T // 8) * 8


@pytest.mark.parametrize("block_np", [16, 64])
@pytest.mark.parametrize("loss,scale", [("trivial", 0.5), ("cauchy", 2.0)])
def test_linearize_matches_planes(problem, loss, scale, block_np):
    scene, grid, free = problem
    sp = slot_params(scene.params, grid)
    fo, fi, fk = _free_tables(scene, grid, free)
    pts = scene.params.points
    pf = free.points

    ref = linearize_planes(
        pts, sp, grid, grid.xy0, grid.xy1, grid.mask, fo, fi, fk, pf,
        loss=loss, loss_scale=scale,
    )
    starts, width = _one_band(pts, grid, block_np)
    got = linearize_banded(pts, pf, sp, grid, fo, fi, fk, starts, width,
                           loss=loss, loss_scale=scale, block_np=block_np)
    for g, r in zip(got[:5], ref[:5]):
        np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got[5]), np.asarray(ref[5]),
                               rtol=1e-8, atol=1e-10)


def test_cost_matches_planes(problem):
    """The chunked plane cost pass (chunks smaller than the point count)
    and the one-band banded cost pass both match the plane reference."""
    scene, grid, _ = problem
    sp = slot_params(scene.params, grid)
    pts = scene.params.points
    ref = cost_planes(pts, sp, grid.xy0, grid.xy1, grid.mask,
                      loss="huber", loss_scale=3.0)
    got = grid_cost(pts, sp, grid, loss="huber", loss_scale=3.0,
                    chunk_size=16, impl="planes")
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    starts, width = _one_band(pts, grid, 16)
    got_b = cost_banded(pts, sp, grid, starts, width, loss="huber",
                        loss_scale=3.0, block_np=16)
    np.testing.assert_allclose(got_b, ref, rtol=1e-10)


def test_grid_step_planes_matches_einsum(problem):
    """A full LM step through the solver: the plane path and the reference
    einsum formulation make the same accept decision and iterates."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.residuals.reprojection import flatten_camera
    from deeparc_tpu.solver.rig_grid import init_grid_state, make_grid_step

    scene, grid, free = problem
    options = SolverOptions(linear_solver="dense_schur")
    cam_free = flatten_camera(free)
    point_free = free.points

    outs = {}
    for impl in ("planes", "einsum"):
        step = make_grid_step(options, scene.params, chunk_size=32, impl=impl)
        state = init_grid_state(scene.params, grid, options, impl=impl)
        state, info = jax.jit(step)(state, grid, cam_free, point_free)
        state, info = jax.jit(step)(state, grid, cam_free, point_free)
        outs[impl] = (state, info)

    s_p, i_p = outs["planes"]
    s_e, i_e = outs["einsum"]
    assert bool(i_p.accepted) == bool(i_e.accepted)
    np.testing.assert_allclose(s_e.cost, s_p.cost, rtol=1e-6)
    np.testing.assert_allclose(s_e.points, s_p.points, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(s_e.cam_vec, s_p.cam_vec, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# Dispatch: the implementations that exist, and nothing else
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asked,want", [
    ("auto", "planes"), ("xla", "planes"), ("planes", "planes"),
    ("einsum", "einsum"),
])
def test_resolve_grid_impl(asked, want):
    assert resolve_grid_impl(asked) == want


@pytest.mark.parametrize("asked", ["pallas", "triton", "dual"])
def test_unknown_grid_impl_raises(problem, asked):
    """A kernel name (or a tile-engine impl) raises at every grid entry
    point instead of running another path."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import make_grid_step, solve_ba_grid

    scene, grid, free = problem
    with pytest.raises(ValueError, match="grid impl"):
        resolve_grid_impl(asked)
    with pytest.raises(ValueError, match="grid impl"):
        make_grid_step(SolverOptions(), scene.params, impl=asked)
    with pytest.raises(ValueError, match="grid impl"):
        solve_ba_grid(scene.params, grid, free, SolverOptions(), impl=asked)


def test_cli_offers_no_kernel_impl():
    from deeparc_tpu.pipeline.cli import build_parser

    p = build_parser()
    assert p.parse_args(["x", "--impl", "auto"]).impl == "auto"
    with pytest.raises(SystemExit):
        p.parse_args(["x", "--impl", "pallas"])
    with pytest.raises(SystemExit):
        p.parse_args(["x", "--platform", "rocm"])


def test_gpu_platform_without_gpu_fails():
    """--platform gpu on a host without a CUDA GPU fails; it never carries
    on on the CPU (the backend is already the CPU in this process, so the
    check sees the platform mismatch)."""
    from deeparc_tpu.pipeline.cli import main
    from deeparc_tpu.utils.platform import PlatformError, select_platform

    assert jax.devices()[0].platform == "cpu"
    old = jax.config.jax_platforms
    try:
        assert select_platform(None) == "cpu"
        with pytest.raises(PlatformError):
            select_platform("gpu")
        assert main(["--synthetic", "--platform", "gpu", "--quiet"]) == 2
    finally:
        jax.config.update("jax_platforms", old)
    assert jax.devices()[0].platform == "cpu"
