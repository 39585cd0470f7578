"""Multi-host scaffolding: jax.distributed + global env mesh.

The reference's only distribution story is N sim processes talking ROS
(SURVEY §2.5).  Here several hosts form ONE logical mesh: each host
drives its local cards, the env axis spans all devices globally, and
cross-instance coupling stays in-mesh.

This module is exercised in CI via the single-process virtual mesh
(tests/test_parallel.py); real pods call :func:`initialize` once per host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None):
    """Join the jax.distributed cluster (no-op when single-process).

    Pass coordinator ("host:port"), num_processes and process_id: nothing
    in a plain GPU or CPU fleet tells JAX of the cluster.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif coordinator is None and jax.process_count() == 1:
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError):
            pass  # single process, nothing to join


def global_env_mesh(axis: str = "env") -> Mesh:
    """Mesh over ALL devices across all hosts (env axis spans the slice)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_local_batch(make_env_state, nenv_global: int, mesh: Mesh):
    """Build a globally-sharded batch from per-host local shards.

    make_env_state(host_env_index) -> Data pytree for one env.  Each host
    materializes only its own shard (nenv_global / process_count envs);
    jax.make_array_from_single_device_arrays stitches the global array —
    the multi-host data-feeding path (no host ever holds the full batch).
    """
    nproc = jax.process_count()
    assert nenv_global % max(1, mesh.devices.size) == 0, (
        "env count must divide the mesh")
    local_envs = nenv_global // nproc
    start = jax.process_index() * local_envs
    states = [make_env_state(start + i) for i in range(local_envs)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *states)
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))

    def shard(x):
        return jax.make_array_from_process_local_data(sharding, np.asarray(x))

    return jax.tree.map(shard, stacked)
