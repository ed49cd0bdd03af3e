"""Multi-host bring-up (SURVEY.md §5 distributed-backend row).

The reference has no distributed layer at all; here multi-host runs use JAX's
standard coordinator + XLA collectives (NCCL between GPUs). This module is the
thin bring-up shim: initialize the process group, build the global mesh, and
expose failure-detection knobs. The process topology is exercised on the CPU: the drill in
tests/test_multiprocess.py runs two OS processes (4 virtual CPU devices each)
through this module — coordination-service bring-up, one 8-device global mesh,
cross-process collectives via Gloo, and heartbeat-based peer-failure
detection (tools/multiproc_worker.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout_s: int = 100,
    initialization_timeout_s: int = 300,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize `jax.distributed` for a multi-process run.

    No-ops when single-process (the common dev path). ``local_device_ids``
    names the GPUs of this host that this process takes: processes sharing a
    host must each take their own (e.g. ``[local_rank]``), since a process
    that opens a card reserves most of its memory. ``None`` takes them all
    (one process per host). Two distinct timeouts:

    * ``initialization_timeout_s`` bounds *startup* — how long processes wait
      for each other at the coordinator barrier.
    * ``heartbeat_timeout_s`` is the *runtime* failure detector
      (``heartbeat_timeout_seconds`` of the coordination service): a host that
      stops heartbeating for this long crashes the job fail-fast instead of
      hanging the next collective. Recovery is restart-from-checkpoint
      (stepth.utils.checkpoint; drill in tests/test_failure_recovery.py).
    """
    if num_processes is None:
        num_processes = int(os.environ.get("STEPTH_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    kw = {} if local_device_ids is None else {"local_device_ids": list(local_device_ids)}
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        initialization_timeout=initialization_timeout_s,
        heartbeat_timeout_seconds=heartbeat_timeout_s,
        **kw,
    )


def global_mesh(data: int = 1, tile: Optional[int] = None) -> Mesh:
    """Build the (data, tile) mesh over ALL devices across hosts. The
    ``tile`` axis is innermost so halo ppermutes stay between devices of one
    host, and the ``data`` axis outermost so batch all-reduces cross hosts
    only once per host group."""
    devs = jax.devices()
    n = len(devs)
    if tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    grid = np.array(devs).reshape(data, tile)
    return Mesh(grid, ("data", "tile"))


def process_info() -> Tuple[int, int]:
    """(process_index, process_count)."""
    return jax.process_index(), jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
