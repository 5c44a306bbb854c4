"""Device-mesh utilities — the accelerator replacement for the reference's
only parallel backend: `multiprocessing.Process` fan-out + shared `Array`
gather (deep_learning.py:58-72, nn_train_2.py:56-69).

The scenario axis is the natural data-parallel axis of this workload (every
MPC solve is independent); we shard it over a 1-D mesh and reduce policy
gradients with `psum` (NCCL all-reduce over the cards' all-to-all NVLink, so
the mesh follows the algorithm alone).  Multi-host extends the same mesh over
all processes via jax.distributed (each host contributes its local devices);
nothing in the training steps changes — the mesh is the only abstraction.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"


def make_mesh(devices: Optional[Sequence] = None, axis: str = SCENARIO_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices; scenario-parallel."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = SCENARIO_AXIS):
    """Place a pytree of arrays with leading batch dim sharded over the mesh."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. network params) across the mesh."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, tree)
