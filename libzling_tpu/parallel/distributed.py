"""Multi-host scale-out: jax.distributed process groups over the block axis.

The reference is single-process (SURVEY.md section 2: no threads, no MPI);
the framework's distributed equivalent is SPMD over jax.distributed — the
block axis spans every device in the job, collectives ride NVLink within a
host and the network across hosts. ``mesh_encode`` itself is multi-process safe
(mesh.shard_put places host-replicated inputs shard-wise;
mesh.host_gather assembles results with process_allgather), so this module
is the thin process-lifecycle layer around it:

  * ``init_distributed()`` — once per process (explicit args or the
    standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    env vars);
  * ``global_block_mesh()`` — blocks over every device of every host;
  * ``distributed_encode`` — SPMD canonical encode; with
    ``elastic=True``, a device/runtime failure inside a block group falls
    back to the host-side spec encoder for the equivalent canonical bytes
    (blocks are pure functions of bytes + carried state, so recovery
    changes nothing in the output).

Exercised for real by tests/test_multihost.py: a 2-process jax.distributed
CPU job in which every process must assemble the identical canonical
stream (SURVEY.md section 4's multi-process simulation gate).
"""

from __future__ import annotations

import os

import jax

from . import mesh as pmesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize the jax.distributed process group (idempotent).

    Returns True if a multi-process group is active.  With no coordinator
    configured this is a no-op single-process setup.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    num_processes = int(num_processes or os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator, num_processes, process_id)
    return True


def global_block_mesh():
    """Mesh over every device in the job (all hosts), block axis only."""
    return pmesh.make_mesh(jax.devices())


def distributed_encode(data: bytes, level: int,
                       block_size: int = pmesh.BLOCK_SIZE_IN,
                       max_tokens: int = pmesh.BLOCK_SIZE_ROLZ,
                       elastic: bool = False) -> bytes:
    """SPMD canonical encode with blocks sharded over all hosts' devices.

    Every process must call this with the same arguments and receives the
    same stream (byte-identical to ``spec.encode`` at equal geometry).

    elastic=True enables block-group-granular recovery (mesh.py): a device
    failure mid-stream re-encodes only the FAILED group on the host from its
    carried (MTF, level) snapshot — identical bytes, completed groups'
    device work kept.  Recoveries are counted as ``enc.group_failover``.
    """
    mesh = global_block_mesh()
    return pmesh.mesh_encode(data, level, mesh=mesh, block_size=block_size,
                             max_tokens=max_tokens, elastic=elastic)


def distributed_decode(data: bytes, **kwargs) -> bytes:
    """SPMD decode: per-chunk entropy decode sharded over all hosts'
    devices; the format-serial resolve chain runs REPLICATED (an all-gather
    hands every device the token stream, each runs the identical serial
    chain concurrently -- same wall time, and every process assembles the
    output without cross-process device access).  Every process must call
    this with the same arguments and receives the same bytes.
    kwargs pass through to parallel.decode_mesh.mesh_decode."""
    from . import decode_mesh as dmesh

    return dmesh.mesh_decode(data, mesh=global_block_mesh(), **kwargs)
