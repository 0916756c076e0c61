"""Configuration dataclasses (the reference's #defines / magic numbers as flags).

Every magic number in the reference pipeline becomes an explicit option with
the reference value as its default (SURVEY.md section 5, config row):
100-iteration solves and 3600 s wall-clock caps (``src/sfm.cc:111,121``),
1000-iteration hemisphere fit (``src/sfm.cc:97``), the 5.0 px^2 filter
threshold (``src/sfm.cc:112,122``), DENSE_SCHUR (``src/sfm.cc:67,95``).
Trust-region constants follow Ceres' Solver::Options defaults, which is what
the reference ran with.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Levenberg-Marquardt trust-region + linear-solver options."""

    max_iterations: int = 100          # sfm.cc:111,121 pass 100
    max_seconds: float = 3600.0        # sfm.cc:71,99
    # Ceres trust-region defaults (the reference leaves them untouched)
    initial_radius: float = 1e4
    min_radius: float = 1e-32
    max_radius: float = 1e16
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    # 'dense_schur' (exact reduced camera solve, the reference's
    # ceres::DENSE_SCHUR) or 'iterative_schur' (matrix-free PCG on the
    # Schur complement; the at-scale path)
    linear_solver: str = "dense_schur"
    # ITERATIVE_SCHUR preconditioner: 'block_jacobi' (6x6 Hcc blocks, the
    # Ceres SCHUR_JACOBI analogue) or 'jacobi' (scalar diagonal)
    preconditioner: str = "block_jacobi"
    cg_max_iterations: int = 500
    cg_tolerance: float = 1e-10
    progress_to_stdout: bool = False   # minimizer_progress_to_stdout (sfm.cc:68)
    # robust loss: 'trivial' (the reference's NULL loss, sfm.cc:48), 'cauchy'
    # (its commented-out CauchyLoss(0.5), sfm.cc:49), or 'huber'
    loss: str = "trivial"
    loss_scale: float = 0.5


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    """Outlier-filter options (``DeepArcManager::filterPoint3d``)."""

    error_boundary: float = 5.0        # sfm.cc:112,122
    # The reference removes observations with mse < boundary
    # (DeepArcManager.cc:347-349) — an inverted-looking comparison
    # (SURVEY.md section 2.4). Default is the sane direction (remove
    # mse > boundary); set parity_inverted=True to reproduce the
    # reference literally.
    parity_inverted: bool = False
    # hemisphere distance cut: drop points with d^2 > radius/2
    # (DeepArcManager.cc:387; "radius" is the fitted mean squared distance)
    hemisphere_cut: bool = True


@dataclasses.dataclass
class PipelineOptions:
    """Full solve-filter pipeline options (``src/sfm.cc:77-131``)."""

    solver: SolverOptions = dataclasses.field(default_factory=SolverOptions)
    filter: FilterOptions = dataclasses.field(default_factory=FilterOptions)
    hemisphere_max_iterations: int = 1000   # sfm.cc:97
    write_snapshots: bool = True
    max_filter_rounds: int = 100            # safety cap on the while loop
    # 'auto' = dense (points x cells) grid engine for shared-extrinsic rigs,
    # tile engine for non-shared (BAL-style) scenes — the two at-scale
    # paths; 'grid' / 'indexed' / 'tiles' force one.
    # 'grid-sharded' / 'tiles-sharded' run the SAME pipeline loop with the
    # solves SPMD over a device mesh (parallel/sharded_{grid,tiles}.py) —
    # hemisphere fit, freeze solve, and the solve/filter/snapshot rounds
    # all drive the distributed solvers (SURVEY.md section 2.5).
    engine: str = "auto"
    # mesh size for the *-sharded engines (None = all visible devices)
    devices: int | None = None
    # implementation inside the chosen engine: 'auto' = the plane path
    # (grid, banded when visibility has locality) and 'xla' (tiles); or
    # force 'planes' / 'einsum' (grid) / 'xla' / 'dual' (tiles).
    impl: str = "auto"
