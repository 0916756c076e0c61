"""Card-only checks: float32 on a CUDA GPU against float64 on the CPU.

Marked ``gpu``; the ``cuda_gpu`` fixture skips them off a CUDA GPU. On the
card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/``.
chip_smoke.py runs the same checks, the band parity at flagship size.
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_band_parity_on_card(cuda_gpu):
    r = cs.phase_band_parity(n_points=16384)
    assert all(v <= cs.BAND_BOUNDS[k] for k, v in r["errors"].items())


def test_grid_step_f32_gpu_vs_f64_cpu(cuda_gpu):
    r = cs.phase_grid_step(n_points=8192)
    assert r["grid_step"] <= cs.STEP_BOUNDS["grid_step"]


def test_tile_step_f32_gpu_vs_f64_cpu(cuda_gpu):
    r = cs.phase_tile_step(n_points=4096, n_cameras=128, bal_points=8192,
                           bal_cameras=128)
    assert r["tile_step"] <= cs.STEP_BOUNDS["tile_step"]
