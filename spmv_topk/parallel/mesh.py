"""Device-mesh helpers shared by every sharded engine.

The replacement for the reference's device-level parallel fabric (P1/P2
in SURVEY.md §2.3): 32 row partitions x 32 HBM pseudo-channels on one
FPGA (host_spmv_bscsr.cpp:136-150, Makefile:66-97) become row shards over
a 1D `jax.sharding.Mesh`; the query is replicated (no halo), the merge is
an all_gather of per-shard candidates. The mesh stays 1-D: the cards of
one host are joined all to all (NVLink), so no device order is cheaper
than another.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "shards"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (AXIS,))
