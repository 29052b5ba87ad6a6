"""Multi-host corpus sharding (run one process per host).

  COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=2 PROCESS_ID=<i> \
      python examples/multihost.py

On a single machine this still runs (one process, all local devices).
"""

import os
import sys

import numpy as np

# editable-install fallback: lets the example run from a plain git
# checkout; `pip install -e .` (pyproject.toml) makes this a no-op
if __package__ is None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import spmv_topk as st
from spmv_topk.formats import create_sparse_matrix, create_sample_vector
from spmv_topk.parallel import initialize_multihost, global_mesh
from spmv_topk.parallel.sharded_buckets import ShardedBucketedTopKSpMV

initialize_multihost()  # no-op without COORDINATOR_ADDRESS
mesh = global_mesh()
print("mesh devices:", mesh.devices.size)

corpus = create_sparse_matrix(1_000_000, 1024, 20, "gamma", seed=0)
engine = ShardedBucketedTopKSpMV(corpus, st.TopKSpMVConfig(k=100), mesh=mesh)
idx, vals = engine.query(create_sample_vector(1024, seed=1))
print("top-5:", np.asarray(idx)[:5], np.asarray(vals)[:5])
