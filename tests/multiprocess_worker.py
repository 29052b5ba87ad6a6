"""Worker process for the 2-process jax.distributed CPU test.

Each process owns 4 virtual CPU devices (8 global), packs ONLY its own
row slice (distributed.local_shard_rows), and serves queries through the
global-mesh ShardedBucketedTopKSpMV — the functional model of the
multi-HOST deployment (BASELINE configs 4-5), run without accelerators
the way the reference validates multi-partition behavior in sw_emu
(Makefile:114-138).

Usage: multiprocess_worker.py <process_id> <num_processes> <port>
"""

import json
import os
import sys

proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nprocs,
                           process_id=proc_id)
assert jax.process_count() == nprocs, jax.process_count()

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix, create_sample_vector
from spmv_topk.ops.gold import topk_exact
from spmv_topk.parallel import ShardedBucketedTopKSpMV
from spmv_topk.parallel.distributed import global_mesh, local_shard_rows

mesh = global_mesh()
D = int(mesh.devices.size)
assert D == 4 * nprocs, (D, nprocs)

# Every process generates the same global corpus deterministically, then
# keeps only its local slice (a real deployment loads just the slice).
coo = create_sparse_matrix(128 * 2 * D, 256, 8, "uniform", seed=11)
lo, hi = local_shard_rows(coo.num_rows, mesh)
local = coo.row_slice(lo, hi)
q = create_sample_vector(256, seed=12)
gi, gv = topk_exact(coo, q, 16)

cfg = TopKSpMVConfig(k=16, lane_k=8, max_cols=256)
eng = ShardedBucketedTopKSpMV(local, cfg, mesh=mesh,
                              local_rows=(lo, coo.num_rows))
idx, vals = map(np.asarray, eng.query(q))
precision = len(set(gi.tolist()) & set(idx.tolist())) / 16

# Rescore path: per-host CSR slice + cross-process candidate merge, on
# the production word format (h16 + quantum-1) so the skeleton exchange
# (width, slice-count slots) and the value-scale exchange run across
# real processes.
cfg2 = TopKSpMVConfig(k=16, lane_k=8, max_cols=256, query_codec="h16",
                      width_quantum=1, rescore_pool=64)
eng2 = ShardedBucketedTopKSpMV(local, cfg2, mesh=mesh,
                               local_rows=(lo, coo.num_rows))
i2, v2 = map(np.asarray, eng2.query(q))
p2 = len(set(gi.tolist()) & set(i2.tolist())) / 16

print("RESULT " + json.dumps(dict(
    proc=proc_id, devices=D, rows=[int(lo), int(hi)],
    precision=precision, precision_rescore=p2)))
assert precision >= 0.85, precision
assert p2 >= 0.95, p2
np.testing.assert_allclose(np.sort(v2), np.sort(gv), atol=1e-5)

# Per-shard snapshot round trip across processes (VERDICT r3 #3): each
# process writes only its own devices' shards, then loads only its own —
# multi-process pack-once serving.


from jax.experimental import multihost_utils

snapdir = os.environ.get("SPMV_SNAP_DIR")
if snapdir:
    path = os.path.join(snapdir, "snap")
    eng2.save(path)
    multihost_utils.sync_global_devices("snapshot written")
    eng3 = ShardedBucketedTopKSpMV.load(
        path, mesh=mesh, matrix=local, local_rows=(lo, coo.num_rows))
    i3, v3 = map(np.asarray, eng3.query(q))
    np.testing.assert_array_equal(i3, i2)
    np.testing.assert_allclose(v3, v2, atol=1e-6)
    print("SNAPSHOT ok")

jax.distributed.shutdown()
