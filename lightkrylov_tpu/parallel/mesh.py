"""Device mesh and distribution utilities.

Replacement for the reference's deliberately-thin MPI layer
(reference: src/Constants.f90:60-100 rank plumbing; src/Utilities/
Logger.f90:245-276 ``comm_setup`` — the reference never issues a collective
itself and delegates all distribution to user code, paper/paper.md:35,97,101).

Here the framework owns distribution (SURVEY.md §2 parallelism inventory,
item 4): ``jax.distributed`` bootstrap over hosts, a named device mesh over
ICI/DCN, ``NamedSharding`` placement for state vectors, and process-0-gated
logging.  Solvers stay sharding-oblivious: once vectors carry shardings,
XLA GSPMD turns every batched inner product of the CGS2 layer into a single
fused all-reduce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants
from ..utils.logger import log_information

__all__ = [
    "comm_setup",
    "comm_close",
    "make_mesh",
    "distribute",
    "replicate",
    "shard_rows",
    "P",
    "Mesh",
    "NamedSharding",
]


def comm_setup(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize multi-host JAX (reference: ``comm_setup``,
    Logger.f90:245-276 — MPI init-if-needed + rank capture).

    No-op in single-process mode.  Multi-process runs pass the
    coordinator address, process count and process id explicitly.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        # Cross-process collectives on the CPU backend need an explicit
        # implementation (gloo ships with jaxlib); must be selected before
        # the backend initializes.  Harmless on GPUs (per-backend setting).
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # pragma: no cover - older jaxlib without the flag
            pass
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    log_information(
        f"comm_setup: process {constants.get_rank()}/{constants.get_comm_size()}, "
        f"{jax.device_count()} devices ({jax.local_device_count()} local)",
        "parallel", "comm_setup",
    )


def comm_close() -> None:
    """Tear down the multi-process runtime (reference: ``comm_close``,
    Logger.f90:277-288 — MPI finalize-if-needed).

    Safe to call unconditionally: a no-op when ``jax.distributed`` was never
    initialized (single-process mode), mirroring the reference's
    ``mpi_initialized``-guarded finalize.
    """
    try:
        jax.distributed.shutdown()
    except RuntimeError:
        # Not initialized — single-process mode, nothing to finalize.
        pass
    log_information("comm_close: distributed runtime shut down",
                    "parallel", "comm_close")


def make_mesh(n_devices: int | None = None, axis_name: str = "i",
              devices=None) -> Mesh:
    """1D device mesh over all (or the first ``n_devices``) devices.

    The single distribution axis of a Krylov library is state-vector
    partitioning (SURVEY.md §2: operator/state-vector partitioning is the
    relevant axis — there is no TP/PP/EP analogue), so a 1D mesh is the
    default; build 2D meshes directly with ``jax.make_mesh`` for block
    partitioning.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_rows(mesh: Mesh, axis_name: str | None = None) -> NamedSharding:
    """Sharding that partitions the leading (row) axis over the mesh."""
    axis_name = axis_name or mesh.axis_names[0]
    return NamedSharding(mesh, P(axis_name))


def distribute(x, mesh: Mesh, spec: P | None = None):
    """Place a pytree vector on the mesh: every leaf partitioned along its
    leading axis by default (row partitioning of the state vector —
    SURVEY.md §2 item 1)."""
    if spec is None:
        spec = P(mesh.axis_names[0])

    def place(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(place, x)


def replicate(x, mesh: Mesh):
    """Fully replicate a pytree over the mesh (small dense projected
    quantities: Hessenberg matrices, Givens buffers)."""

    def place(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    return jax.tree.map(place, x)
