"""deeparc_tpu — a structure-from-motion / bundle-adjustment framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
``pureexe/deeparc-sfm`` (a C++/Ceres program; see SURVEY.md): the ``.deeparc``
rig format, Snavely-style reprojection residuals with shared arc x ring
hemisphere-rig extrinsics, a hemisphere-radius camera prior, iterative
solve-then-filter bundle adjustment — plus the numerical engine the reference
delegated to Ceres (forward-mode autodiff, Levenberg-Marquardt trust region,
Schur-complement elimination, reduced camera solves), reimplemented here as
batched block-sparse linear algebra on flat arrays, jit/``lax.while_loop``
drivers, and a ``shard_map`` distributed Schur complement over device
meshes. The package name records where the system comes from; it
runs on CUDA GPUs (NVIDIA H100) and, for tests, on the CPU.

Layer map (mirrors SURVEY.md section 7):
  io/        .deeparc parser/writer, PLY export, BAL reader, synthetic rigs
  geometry/  rotation kernels, projection model, camera centers
  scene      flat-array scene representation (replaces the pointer graph)
  residuals/ batched reprojection + hemisphere residuals and Jacobian blocks
  solver/    LM trust-region loop, Schur complement, PCG
  parallel/  shard_map distributed Schur over a device mesh
  pipeline/  hemisphere fit -> freeze solve -> filter loop driver, CLI
"""

__version__ = "0.1.0"


def enable_x64() -> None:
    """Enable float64 in JAX (needed for Ceres-parity accuracy on CPU)."""
    import jax

    jax.config.update("jax_enable_x64", True)
