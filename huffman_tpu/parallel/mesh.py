"""Device mesh construction and multi-host initialization.

The reference's entire "distributed" layer is picking one GPU
(reference: cuda_helpers.h:11-38); its communication backend row in
SURVEY.md section 2 is empty.  This module is its replacement:
a 1-D jax.sharding.Mesh over all devices (the block axis is the only
parallel axis of this workload — data parallelism over independent blocks,
SURVEY.md section 2 parallelism table), with jax.distributed for multi-host
clusters.  TP/PP/EP are N/A for a codec (same table); the per-shard
histograms, the codebook broadcast and the bit-count fetch all ride this
one mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (num_blocks, ...) arrays: split on the block axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Replicated sharding (codebook LUTs, decode tables, scalars)."""
    return NamedSharding(mesh, P())


def fetch(x) -> np.ndarray:
    """Host value of a device array — multi-process-safe.

    np.asarray on a jax.Array spanning non-addressable devices raises;
    on a multi-host mesh the value is re-replicated through the runtime
    (one collective across processes) so every process gets the full array,
    which is what the host-side orchestration (plans, container headers)
    needs.  Single-process arrays take the plain np.asarray path."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def put_global(host_arr, sharding: NamedSharding) -> jax.Array:
    """Upload a host-global array under `sharding` — multi-process-safe.

    Single-process: plain device_put.  Multi-process: every process holds
    the same full host value (the orchestration is replicated), so the
    global array is built from per-shard callbacks — each process uploads
    only its addressable shards, no cross-host data motion."""
    host_arr = np.asarray(host_arr)
    if jax.process_count() > 1:
        return jax.make_array_from_callback(
            host_arr.shape, sharding, lambda idx: host_arr[idx])
    return jax.device_put(host_arr, sharding)


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host cluster.

    Pass the coordinator address, process count and process id
    explicitly (nothing here discovers a cluster).  Collectives then run
    across all processes through the same mesh code — no transport code
    here (SURVEY.md section 5, distributed-communication row).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pad_blocks_for_mesh(num_blocks: int, mesh: Mesh) -> int:
    """Blocks after padding to a multiple of the mesh size."""
    n = mesh.devices.size
    return -(-num_blocks // n) * n
