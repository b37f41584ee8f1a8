"""Multi-host initialization and mesh construction.

The reference's only distributed mode is Stan map_rect over MPI ranks
(SURVEY.md §5); the equivalent here is a jax.distributed cluster with a 2-D
(hosts-spanning) mesh: the gene axis shards across hosts, chains over the
remaining devices. XLA GSPMD inserts the collectives; nothing else in
the framework changes — the same `run_hmc(mesh=...)` / sharded-NUTS paths
run unmodified because shardings are data annotations, not code.

This module cannot be exercised on single-host CI; its mesh logic is tested
on the virtual 8-device CPU mesh (tests/test_sharding.py) and a real
2-process CPU cluster (tests/test_multihost.py).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (no-op if already initialized).

    Pass all three arguments: no cluster environment announces them
    (coordinator_address is `host:port` of process 0).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def pod_mesh(chains_axis: int | None = None) -> Mesh:
    """2-D (chains, genes) mesh over every device in the cluster.

    `chains_axis` devices (default: devices per host) form the chain-parallel
    axis; the rest shard genes. Device order follows jax.devices(), which
    groups by process — the gene axis therefore spans hosts only when it
    must, keeping the high-traffic all-reduces inside a host.
    """
    devices = np.array(jax.devices())
    n = len(devices)
    if chains_axis is None:
        chains_axis = max(1, jax.local_device_count())
    while n % chains_axis != 0:
        chains_axis -= 1
    return Mesh(devices.reshape(chains_axis, n // chains_axis), ("chains", "genes"))
