"""Live-band grid engine: band prep invariants + banded parity.

The banded linearization (rig_planes.linearize_banded), with per-group
widths or one uniform width, must produce bit-for-tolerance the same
linearization as the plane-form reference on the band-prepared grid:
banding only skips cell slabs that band_grid guarantees are dead. The
banded LM steps and solves must match the unbanded plane path, with and
without a robust loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeparc_tpu.io.synthetic import make_grid_rig_device
from deeparc_tpu.solver.rig_band import (
    band_grid,
    banded_planes,
    gather_banded_planes,
)
from deeparc_tpu.solver.rig_grid import slot_params
from deeparc_tpu.solver.rig_planes import (
    cost_banded,
    cost_planes,
    linearize_banded,
    linearize_planes,
)

# band layouts under test: per-group widths (what band_grid picks) and one
# uniform width paid by every tile
LAYOUTS = ["groups", "uniform"]
# losses for the banded step/solve cases: plain least squares and robust
LOSSES = ["trivial", "huber"]


@pytest.fixture(scope="module")
def problem():
    # f64 so the parity comparison is not limited by f32 accumulation-order
    # noise (tests/conftest.py enables x64; the GPU runs f32)
    params, grid, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=420, occlusion_rings=4, visibility=0.9,
        pixel_noise=0.8, point_noise=0.02, seed=5, dtype=jnp.float64,
    )
    prep = band_grid(grid, block_np=64, cost_block_np=128)
    return params, grid, prep


def test_band_prep_invariants(problem):
    params, grid, prep = problem
    T = grid.mask.shape[1]
    t_pad = -(-T // 8) * 8
    assert prep is not None, "occlusion rig must produce a narrow band"
    assert prep.w_band < t_pad
    assert prep.w_band % 8 == 0

    # every live cell of every point tile lies inside its cyclic band
    mask = np.asarray(prep.grid.mask)
    starts = np.asarray(prep.grid.band[0])
    N = mask.shape[0]
    bn = 64
    for i, s0 in enumerate(starts):
        rows = mask[i * bn: (i + 1) * bn]
        if rows.size == 0:
            continue
        live = np.nonzero(rows.any(axis=0))[0]
        inside = (live - s0 * 8) % t_pad < prep.w_band
        assert inside.all(), (i, s0, live)

    # the permutation is a bijection that maps sorted rows back to originals
    perm = np.asarray(prep.perm)
    inv = np.asarray(prep.inv)
    assert (perm[inv] == np.arange(N)).all()
    # same number of live observations before and after the re-layout
    assert np.isclose(mask.sum(), np.asarray(grid.mask).sum())


def test_band_grid_declines_without_locality():
    """Dense and uniform-random masks must fall back to the unbanded paths
    (banding is an optimization, never a requirement)."""
    params_d, grid_d, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=256, occlusion_rings=None,
        visibility=None, seed=1, dtype=jnp.float64)
    assert band_grid(grid_d, block_np=64) is None          # dense

    params_r, grid_r, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=256, occlusion_rings=None,
        visibility=0.2, seed=1, dtype=jnp.float64)
    assert band_grid(grid_r, block_np=64) is None          # uniform random


def _free_tables(grid, dtype):
    T = grid.mask.shape[1]
    ones = jnp.ones((T, 6), dtype)
    return ones, ones, ones


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("loss,scale", [("trivial", 0.5), ("huber", 2.0)])
def test_banded_linearize_matches_planes(problem, loss, scale, layout):
    params, grid, prep = problem
    g = prep.grid
    pts = params.points[prep.perm]
    pf = jnp.ones_like(pts)
    sp = slot_params(params, g)
    fo, fi, fk = _free_tables(g, pts.dtype)

    ref = linearize_planes(
        pts, sp, g, g.xy0, g.xy1, g.mask, fo, fi, fk, pf,
        loss=loss, loss_scale=scale,
    )
    starts = g.band[0]
    if layout == "groups":
        w_band, pxm = prep.lin_groups or prep.w_band, g.band[2]
    else:
        w_band = prep.w_band
        n_tiles = starts.shape[0]
        pxm = gather_banded_planes(banded_planes(g, n_tiles * 64, w_band),
                                   starts, w_band, 64, 0, n_tiles)
    got = linearize_banded(pts, pf, sp, g, fo, fi, fk, starts, w_band,
                           loss=loss, loss_scale=scale, block_np=64, pxm=pxm)
    cost_r, gp_r, hpp_r, gs_r, hcc_r, e_r = ref
    cost_g, gp_g, hpp_g, gs_g, hcc_g, e_g = got

    np.testing.assert_allclose(cost_g, cost_r, rtol=1e-5)
    np.testing.assert_allclose(gp_g, gp_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hpp_g, hpp_r, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gs_g, gs_r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hcc_g, hcc_r, rtol=1e-4, atol=1e-4)

    np.testing.assert_allclose(np.asarray(e_g), np.asarray(e_r), rtol=1e-4,
                               atol=1e-5)


def test_banded_cost_matches_planes(problem):
    params, grid, prep = problem
    g = prep.grid
    pts = params.points[prep.perm]
    sp = slot_params(params, g)
    ref = cost_planes(pts, sp, g.xy0, g.xy1, g.mask,
                      loss="cauchy", loss_scale=3.0)
    got = cost_banded(pts, sp, g, g.band[1],
                      prep.cost_groups or prep.w_band_cost,
                      loss="cauchy", loss_scale=3.0, block_np=128,
                      pxm=g.band[3])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("loss", LOSSES)
def test_banded_step_matches_planes(problem, loss):
    """Two full LM steps: banded == unbanded plane-form XLA on the banded
    grid (same accept decisions, costs, iterates)."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import init_grid_state, make_grid_step

    params, grid, prep = problem
    g = prep.grid
    import dataclasses

    params_s = dataclasses.replace(params, points=params.points[prep.perm])
    C = 6 * (params.ext_rot.shape[0] + params.center.shape[0])
    cam_free = jnp.ones((C,), params.points.dtype).at[:6].set(0.0)
    point_free = jnp.ones_like(params_s.points)

    options = SolverOptions(linear_solver="dense_schur", loss=loss,
                            loss_scale=2.0)
    bws, bbs = prep.widths
    outs = {}
    for key, bw, bb in (("ref", (0, 0), (0, 0)), ("band", bws, bbs)):
        step = make_grid_step(options, params_s, chunk_size=64,
                              band_widths=bw, band_blocks=bb)
        state = init_grid_state(params_s, g, options,
                                band_widths=bw, band_blocks=bb)
        state, info = jax.jit(step)(state, g, cam_free, point_free)
        state, info = jax.jit(step)(state, g, cam_free, point_free)
        outs[key] = (state, info)

    s_p, i_p = outs["ref"]
    s_k, i_k = outs["band"]
    assert bool(i_p.accepted) == bool(i_k.accepted)
    np.testing.assert_allclose(s_k.cost, s_p.cost, rtol=1e-5)
    np.testing.assert_allclose(s_k.points, s_p.points, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s_k.cam_vec, s_p.cam_vec, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
def test_banded_step_intr_frozen_ext_only_E(problem, loss):
    """band_intr_frozen=True: the banded paths omit the intrinsic E columns
    (ext-only E) — with intrinsics actually frozen this must reproduce the
    plane-form step exactly."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import init_grid_state, make_grid_step

    params, grid, prep = problem
    g = prep.grid
    import dataclasses

    params_s = dataclasses.replace(params, points=params.points[prep.perm])
    R = params.ext_rot.shape[0]
    C = 6 * (R + params.center.shape[0])
    cam_free = jnp.ones((C,), params.points.dtype)
    cam_free = cam_free.at[:6].set(0.0)           # gauge extrinsic
    cam_free = cam_free.at[6 * R:].set(0.0)       # frozen intrinsics
    point_free = jnp.ones_like(params_s.points)

    options = SolverOptions(linear_solver="dense_schur", loss=loss,
                            loss_scale=2.0)
    bws, bbs = prep.widths
    outs = {}
    for key, bw, bb, frz in (("ref", (0, 0), (0, 0), False),
                             ("band", bws, bbs, True)):
        step = make_grid_step(options, params_s, chunk_size=64,
                              band_widths=bw, band_blocks=bb,
                              band_intr_frozen=frz)
        state = init_grid_state(params_s, g, options,
                                band_widths=bw, band_blocks=bb)
        state, info = jax.jit(step)(state, g, cam_free, point_free)
        state, info = jax.jit(step)(state, g, cam_free, point_free)
        outs[key] = (state, info)

    s_p, i_p = outs["ref"]
    s_k, i_k = outs["band"]
    assert bool(i_p.accepted) == bool(i_k.accepted)
    np.testing.assert_allclose(s_k.cost, s_p.cost, rtol=1e-5)
    np.testing.assert_allclose(s_k.points, s_p.points, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s_k.cam_vec, s_p.cam_vec, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
def test_solve_ba_grid_band_auto_matches_planes(loss):
    """solve_ba_grid(band='auto') on an occlusion scene: banding engages
    internally (points permuted in, un-permuted out) and the returned
    params must match the unbanded plane-form solve in ORIGINAL point
    order."""
    import dataclasses

    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import solve_ba_grid

    params, grid, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=300, occlusion_rings=4, visibility=0.9,
        pixel_noise=0.8, point_noise=0.02, seed=7, dtype=jnp.float64,
    )
    C_ext = params.ext_rot.shape[0]
    free = dataclasses.replace(
        params,
        points=jnp.ones_like(params.points),
        ext_rot=jnp.ones_like(params.ext_rot).at[0].set(0.0),
        ext_trans=jnp.ones_like(params.ext_trans).at[0].set(0.0),
        center=jnp.zeros_like(params.center),
        focal=jnp.zeros_like(params.focal),
        dist=jnp.zeros_like(params.dist),
    )
    options = SolverOptions(linear_solver="dense_schur", max_iterations=3,
                            loss=loss, loss_scale=2.0)
    res_p = solve_ba_grid(params, grid, free, options, impl="planes",
                          chunk_size=128, band="none")
    res_b = solve_ba_grid(params, grid, free, options, impl="planes",
                          chunk_size=128, band="auto")
    np.testing.assert_allclose(res_b.cost, res_p.cost, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res_b.params.points),
                               np.asarray(res_p.params.points),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
def test_band_reuse_across_filter_rounds(loss):
    """band_reuse: the pipeline's second round refreshes the stored prep
    (band_grid_update — same orderings/widths/starts, planes re-gathered
    for the SHRUNK mask) and must match a fresh prep's solve exactly
    (the filter only removes observations, so stored covers stay valid)."""
    import dataclasses

    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.rig_grid import solve_ba_grid

    params, grid, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=300, occlusion_rings=4, visibility=0.9,
        pixel_noise=0.8, point_noise=0.02, seed=7, dtype=jnp.float64,
    )
    free = dataclasses.replace(
        params,
        points=jnp.ones_like(params.points),
        ext_rot=jnp.ones_like(params.ext_rot).at[0].set(0.0),
        ext_trans=jnp.ones_like(params.ext_trans).at[0].set(0.0),
        center=jnp.zeros_like(params.center),
        focal=jnp.zeros_like(params.focal),
        dist=jnp.zeros_like(params.dist),
    )
    options = SolverOptions(linear_solver="dense_schur", max_iterations=2,
                            loss=loss, loss_scale=2.0)
    state: dict = {}
    solve_ba_grid(params, grid, free, options, chunk_size=128, band="auto",
                  band_reuse=state)
    assert state["prep"] is not None

    # filter round: drop ~15% of live observations
    rng = np.random.default_rng(3)
    mask = np.asarray(grid.mask)
    drop = (rng.random(mask.shape) < 0.15) & (mask > 0.5)
    grid2 = grid._replace(mask=jnp.asarray(mask * ~drop, mask.dtype))

    res_reuse = solve_ba_grid(params, grid2, free, options, chunk_size=128,
                              band="auto", band_reuse=state)
    res_fresh = solve_ba_grid(params, grid2, free, options, chunk_size=128,
                              band="auto")
    np.testing.assert_allclose(res_reuse.cost, res_fresh.cost, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res_reuse.params.points),
                               np.asarray(res_fresh.params.points),
                               rtol=1e-6, atol=1e-9)
