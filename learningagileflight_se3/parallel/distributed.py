"""Multi-host initialization — the cross-host half of the parallel backend.

The reference's only scaling mechanism is a single-host fork
(deep_learning.py:66-72).  Here the scenario mesh extends across hosts: every
process calls :func:`initialize_distributed`, contributes its local devices,
and the SAME `shard_map`/`psum` training steps (train/rl.py) run unchanged —
gradients reduce over NVLink within a host (NCCL) and the network across
hosts, with the mesh as the only abstraction.

Nothing discovers a cluster by itself: every process is told the
coordinator address, the process count and its own rank, either as
arguments or through the ``LAF_*`` variables (also used by the
multi-process CPU test, SURVEY.md §4 anchor 5):

    LAF_COORDINATOR_ADDRESS   host:port of process 0
    LAF_NUM_PROCESSES         total process count
    LAF_PROCESS_ID            this process's rank
    LAF_LOCAL_DEVICE_COUNT    (CPU only) virtual devices per process
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> bool:
    """Initialize jax.distributed for multi-host execution.

    Arguments default to the LAF_* environment variables; with none present
    and no auto-discovery requested this is a no-op returning False
    (single-process mode), so drivers can call it unconditionally.

    MUST run before the first backend use (any jax.devices()/array op).
    For the CPU backend, `local_device_count` virtual devices per process and
    gloo cross-process collectives are configured.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "LAF_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "LAF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LAF_NUM_PROCESSES"])
    if process_id is None and "LAF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LAF_PROCESS_ID"])
    if local_device_count is None and "LAF_LOCAL_DEVICE_COUNT" in os.environ:
        local_device_count = int(os.environ["LAF_LOCAL_DEVICE_COUNT"])

    if coordinator_address is None and num_processes is None:
        return False  # single-process

    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_batch_from_host(mesh, x, axis: str = "scenario"):
    """Make a globally-sharded batch from a host array every process holds in
    full (e.g. identically-seeded scenario samples): each process keeps only
    its addressable shards.  Works identically in single-process mode."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = np.asarray(x)
    sharding = NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
