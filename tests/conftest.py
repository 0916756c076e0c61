"""Test configuration: run on CPU with 8 virtual devices and float64 enabled.

Tests run on the local CPU backend with a virtual 8-device mesh (SURVEY.md
section 4: distributed tests use ``--xla_force_host_platform_device_count``),
so the platform is set via jax.config before any backend is initialized.
Tests that need a CUDA GPU carry the ``gpu`` marker and take the
``cuda_gpu`` fixture, which skips them on the CPU. On the card they run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from deeparc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: many tests lower IDENTICAL HLO (same step
# function shapes across parametrizations and engines); the disk cache
# turns every repeat into a cheap deserialize, across runs and within one.
enable_compile_cache(min_compile_secs=0.3, min_entry_bytes=-1)


@pytest.fixture
def cuda_gpu():
    """Skip unless the default JAX device is a CUDA GPU (decided at run
    time, never at import, so every xdist worker collects the same tests).
    """
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; run on the card with "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu "
                    "-p no:xdist tests/`")
