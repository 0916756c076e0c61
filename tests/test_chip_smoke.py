"""chip_smoke.py's phases at a tiny size on the CPU.

On the card the same functions run at full size; here they check wiring,
shapes and the comparisons themselves.
"""

import pytest

import chip_smoke as cs


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_band_parity_phase():
    r = cs.phase_band_parity(n_points=2048)
    assert r["banded_ms"] > 0 and r["unbanded_ms"] > 0
    assert set(r["errors"]) == set(cs.BAND_BOUNDS)


def test_grid_step_phase():
    r = cs.phase_grid_step(n_points=512)
    assert r["grid_cost"] <= cs.STEP_BOUNDS["grid_cost"]


def test_tile_step_phase():
    r = cs.phase_tile_step(n_points=512, n_cameras=32, bal_points=1024,
                           bal_cameras=32)
    assert r["tile_step_ms"] > 0


def test_flagship_phase():
    r = cs.phase_flagship(n_points=1500)
    assert r["final_rmse_px"] <= cs.RMSE_MAX_PX
    assert r["points_alive"] == r["warm"]["points_alive"]


def test_tiles_pipeline_phase():
    r = cs.phase_tiles_pipeline(n_points=2000, n_cameras=100)
    assert r["points_alive"] > 0


def test_four_cards_phase():
    r = cs.phase_four_cards(n_points=1500, bal_points=2000)
    assert r["grid_cost_rel"] <= cs.SHARDED_COST_RTOL
    assert r["tiles_cost_rel"] <= cs.SHARDED_COST_RTOL
    assert len(r["shards"]) == 4


def test_cli_golden_phase():
    assert cs.phase_cli_golden("cpu")["wall_s"] > 0


def test_check_raises_out_of_bounds():
    with pytest.raises(cs.CheckFailed):
        cs._check("x", {"cost": 1.0}, {"cost": 1e-5})
    with pytest.raises(cs.CheckFailed):
        cs._check("x", {"cost": float("nan")}, {"cost": 1e-5})
