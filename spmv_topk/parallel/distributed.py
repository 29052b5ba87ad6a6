"""Multi-host initialization and mesh helpers.

The reference is a single-host system (one FPGA card, one process;
SURVEY.md §2.4). Scaling the corpus beyond one host (BASELINE.json
configs 4-5: 100M and 500M rows) uses jax.distributed + a global 1D mesh
over all devices; rows are sharded in contiguous blocks per device and
the Top-K merge all_gather moves only k (value, index) pairs per device,
so the cross-host hop is small next to the SpMV sweep.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import AXIS


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process or already initialized."""
    if jax.process_count() > 1:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return  # single-host
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=int(num_processes or os.environ["NUM_PROCESSES"]),
        process_id=int(process_id or os.environ["PROCESS_ID"]),
    )


def global_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1D mesh over all global devices, ordered host-major so contiguous
    row shards land on the devices of one host first (merge traffic stays
    within a host until the final cross-host hop)."""
    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devices), (AXIS,))


def local_shard_rows(num_rows: int, mesh: Mesh) -> tuple[int, int]:
    """[lo, hi) row range owned by this process's devices."""
    D = mesh.devices.size
    rows_per = -(-num_rows // D)
    local = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    ids = [list(mesh.devices.flat).index(d) for d in local]
    lo = min(ids) * rows_per
    hi = min((max(ids) + 1) * rows_per, num_rows)
    return lo, hi
