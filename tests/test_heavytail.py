"""Heavy-tailed BAL shapes: generator invariants and an LM step over a
scene whose log-normal tracks span several width buckets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeparc_tpu.io.synthetic import make_bal_heavytail_device


@pytest.fixture(scope="module")
def problem():
    params, tiles, gt, cam_free = make_bal_heavytail_device(
        n_cameras=32, n_points=200, mean_track=5.0, sigma=0.8,
        max_track=32, window=16, chunk_obs=256, pixel_noise=0.5,
        point_noise=0.03, seed=3, dtype=jnp.float64,
    )
    return params, tiles, cam_free


def test_generator_invariants(problem):
    params, tiles, cam_free = problem
    assert len(tiles.buckets) >= 3, "log-normal tracks must span buckets"
    widths = [b.cell.shape[1] for b in tiles.buckets]
    assert widths == sorted(widths)
    # per-row live count <= W and within the clip range on live rows
    total = 0
    for b in tiles.buckets:
        m = np.asarray(b.mask)
        live = m.sum(axis=1)
        assert (live <= b.cell.shape[1]).all()
        total += m.sum()
    assert total > 200 * 2  # every (non-pad) point has >= 2 observations
    # narrow buckets carry locality blocking; the widest may not
    assert any(b.loc for b in tiles.buckets)
    # cells referenced by live slots are valid camera ids
    V = int(tiles.cells.slot_outer.shape[0])
    for b in tiles.buckets:
        cells = np.asarray(b.cell)[np.asarray(b.mask) > 0.5]
        assert cells.min() >= 0 and cells.max() < V


@pytest.mark.slow
def test_heavytail_step_converges(problem):
    """One accepted LM step through make_tile_step on the multi-bucket
    problem. Slow: the 4-bucket step is one large XLA compile."""
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.solver.tiles import init_tile_state, make_tile_step

    params, tiles, cam_free = problem
    cam_free = cam_free.at[:6].set(0.0)
    point_free = jnp.ones_like(params.points)
    options = SolverOptions(linear_solver="iterative_schur",
                            cg_max_iterations=12)
    step = make_tile_step(options, params, chunk_obs=256, impl="xla")
    state = init_tile_state(params, tiles, options, cam_free,
                            chunk_obs=256)
    c0 = float(state.cost)
    state, info = jax.jit(step)(state, tiles, cam_free, point_free)
    assert bool(info.accepted)
    assert float(state.cost) < c0
