"""Multi-host runtime entry (SURVEY §2.9 P7).

The reference distributes across machines with a cloud work queue +
files (scripts/cloud/server.py); this runtime has two tiers:

  * ``initialize()`` — `jax.distributed.initialize` for multi-host
    clusters: every host joins one JAX runtime, `jax.devices()` spans
    all cards, and the shard_map pipelines in parallel/distributed.py
    run unchanged over the global mesh (collectives ride NVLink within
    a host and the network across hosts).
  * the coarse-grained work queue (parallel/coordinator.py + the
    `metagraph coordinator` / `metagraph worker` CLI) for clusters
    without a shared JAX runtime — per-suffix chunk builds fan out to
    workers and `concatenate` merges the chunks.

Single-chip environments simply skip `initialize()`; everything else is
identical.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the multi-host JAX runtime. Arguments default to the standard
    environment variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID). Returns True when a multi-host
    runtime was initialized, False when running single-process."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator_address and num_processes is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_mesh(axis: str = "x") -> Mesh:
    """1-D mesh over every device of every participating host."""
    return Mesh(np.array(jax.devices()), (axis,))


def is_primary() -> bool:
    return jax.process_index() == 0
