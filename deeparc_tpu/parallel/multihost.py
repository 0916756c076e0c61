"""Multi-host execution: jax.distributed startup, (hosts, chips) meshes,
host-local data loading, and the multi-host grid solve.

The reference has no distributed capability (its only parallelism is Ceres'
thread pool, ``src/sfm.cc:70``); this module is the new capability mandated
by BASELINE.json (>= 75% scaling efficiency at >= 2 hosts) and SURVEY.md
section 7 stage 7. Design:

  * one ``jax.distributed.initialize`` call per process (coordinator from
    args or the standard env vars), after which ``jax.devices()`` is global;
  * a 2-D ``Mesh`` shaped (hosts, chips-per-host): point-major arrays shard
    over BOTH axes (pure data parallelism over point rows), and the reduced
    camera system's psums run over the ("host", "chip") axis pair — XLA
    routes the intra-host part over the host's links and the cross-host
    part over the network;
  * host-local loading: each process materializes only its slice of the
    point-major arrays and assembles the global sharded array with
    ``jax.make_array_from_process_local_data`` — no host ever holds the
    whole problem.

On a single process this degenerates to a (1, n_devices) mesh and is
exercised by tests on the virtual CPU mesh; the 2-process CPU path is
covered by tests/test_multihost.py via subprocesses.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed if a multi-process setup is configured.

    Explicit args win; otherwise the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) are
    used; nothing is autodetected. Returns True when distributed mode is
    active.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_host_mesh(devices=None) -> Mesh:
    """(hosts, chips-per-host) mesh over all global devices.

    Rows are processes (the cross-host axis), columns the process-local
    devices. Single-process: a (1, n) mesh — the same code path
    everywhere.
    """
    devices = list(devices if devices is not None else jax.devices())
    by_proc = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    n_local = {len(v) for v in by_proc.values()}
    if len(n_local) != 1:
        raise ValueError(
            f"uneven devices per process: { {k: len(v) for k, v in by_proc.items()} }")
    rows = [by_proc[k] for k in sorted(by_proc)]
    return Mesh(np.asarray(rows), (HOST_AXIS, CHIP_AXIS))


def data_axes() -> tuple:
    """The axis pair point-major arrays shard over (psum over both)."""
    return (HOST_AXIS, CHIP_AXIS)


def host_point_slice(n_rows_padded: int, mesh: Mesh) -> slice:
    """The global point-row range THIS process must load.

    Point rows are sharded row-major over (hosts, chips); a process owns the
    contiguous block of its mesh row.
    """
    n_hosts = mesh.devices.shape[0]
    assert n_rows_padded % (n_hosts * mesh.devices.shape[1]) == 0
    per_host = n_rows_padded // n_hosts
    h = jax.process_index()
    return slice(h * per_host, (h + 1) * per_host)


def global_from_host_local(local: np.ndarray, mesh: Mesh,
                           n_global: int) -> jax.Array:
    """Assemble a globally point-sharded array from this host's slice."""
    sharding = NamedSharding(mesh, P(data_axes()))
    shape = (n_global,) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local, shape)


def pad_rows_to_mesh(n_rows: int, mesh: Mesh) -> int:
    n_dev = int(mesh.devices.size)
    return -(-n_rows // n_dev) * n_dev


def gather_global(arr) -> np.ndarray:
    """Host-side copy of a (possibly multi-process) sharded array.

    Single-process (and the virtual CPU mesh): a plain transfer. Real
    multi-host: every process all-gathers its addressable shards over the
    interconnect first — the pattern checkpointing needs when no host owns
    the whole array.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return np.asarray(arr)


def solve_ba_grid_multihost(
    params,
    grid,
    free,
    options=None,
    mesh: Mesh | None = None,
    chunk_size: int = 8192,
    impl: str = "planes",
    while_block: int = 10,
    checkpoint_path: str | None = None,
    resume: bool = False,
    logger=None,
):
    """Grid-engine LM solve SPMD over a (hosts, chips) mesh.

    Identical math to ``sharded_grid.solve_ba_grid_sharded`` (to which this
    delegates) — the step's cross-point reductions psum over the
    ("host", "chip") axis PAIR, so the camera system reduces within a host
    and then across hosts. Inherits the blocked driver's
    operational guarantees: ``options.max_seconds`` (``src/sfm.cc:71``),
    per-block checkpointing (process 0 writes), per-block logging.
    """
    from deeparc_tpu.config import SolverOptions
    from deeparc_tpu.parallel.sharded_grid import solve_ba_grid_sharded

    options = options or SolverOptions()
    if mesh is None:
        mesh = make_host_mesh()
    return solve_ba_grid_sharded(
        params, grid, free, options, mesh=mesh, axis=data_axes(),
        chunk_size=chunk_size, impl=impl, while_block=while_block,
        checkpoint_path=checkpoint_path, resume=resume, logger=logger,
    )
