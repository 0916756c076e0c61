"""Choose the JAX platform once, at start-up, and fail if it is not there.

A run asked to use the GPU never carries on on the CPU: when JAX finds no
CUDA device, :func:`select_platform` raises instead of falling back.
"""

from __future__ import annotations


class PlatformError(RuntimeError):
    """The requested JAX platform is not available in this process."""


def select_platform(platform: str | None) -> str:
    """Pin JAX to ``platform`` ("cpu" or "gpu"; None keeps JAX's default)
    before any backend starts, and return the platform JAX then reports.
    Raises :class:`PlatformError` when it differs from the one asked for."""
    import jax

    if platform is not None:
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else platform)
    try:
        found = jax.devices()[0].platform
    except (RuntimeError, AssertionError) as e:
        # jax raises AssertionError when an explicitly requested plugin
        # (cuda) is not installed, RuntimeError when it finds no device
        raise PlatformError(f"JAX found no {platform} device: {e!r}") from e
    if platform is not None and found != platform:
        raise PlatformError(f"asked for {platform}, JAX found {found}")
    return found
