"""Row-sharded dense engine on the virtual CPU mesh."""

import jax
import numpy as np

from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix, create_query_batch
from spmv_topk.ops.gold import topk_exact
from spmv_topk.parallel import ShardedDenseTopKSpMV, make_mesh


def _precision(a, b):
    a = np.asarray(a).tolist()
    b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def test_sharded_dense_matches_exact():
    mesh = make_mesh(jax.devices()[:4])
    # odd row count -> the last shard has pad rows (sentinel masking path)
    coo = create_sparse_matrix(3001, 256, 10, "gamma", seed=100)
    eng = ShardedDenseTopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=256),
                               mesh=mesh, block_rows=512)
    Q = create_query_batch(3, 256, seed=101)
    bi, bv = map(np.asarray, eng.query_batch(Q))
    for i in range(3):
        gi, gv = topk_exact(coo, Q[i], 30)
        assert _precision(gi, bi[i]) >= 0.9
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(gv), atol=5e-3)


def test_sharded_dense_single_query():
    mesh = make_mesh(jax.devices()[:2])
    coo = create_sparse_matrix(2000, 256, 10, "uniform", seed=102)
    eng = ShardedDenseTopKSpMV(coo, TopKSpMVConfig(k=20, max_cols=256),
                               mesh=mesh, block_rows=512)
    q = np.asarray(create_query_batch(1, 256, seed=103)[0])
    i1, _ = map(np.asarray, eng.query(q))
    gi, _ = topk_exact(coo, q, 20)
    assert _precision(gi, i1) >= 0.9


def test_sharded_dense_int8_matches_exact():
    """int8 per-row-scale shards: same sentinel masking + all_gather merge."""
    mesh = make_mesh(jax.devices()[:4])
    coo = create_sparse_matrix(3001, 256, 10, "gamma", seed=100)
    eng = ShardedDenseTopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=256),
                               mesh=mesh, block_rows=512, dtype="int8")
    Q = create_query_batch(3, 256, seed=101)
    bi, bv = map(np.asarray, eng.query_batch(Q))
    for i in range(3):
        gi, gv = topk_exact(coo, Q[i], 30)
        assert _precision(gi, bi[i]) >= 0.85
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(gv), atol=2e-2)


def test_sharded_dense_int8_rescore_exact():
    mesh = make_mesh(jax.devices()[:2])
    coo = create_sparse_matrix(2000, 256, 10, "uniform", seed=102)
    eng = ShardedDenseTopKSpMV(
        coo, TopKSpMVConfig(k=20, max_cols=256, rescore_pool=100),
        mesh=mesh, block_rows=512, dtype="int8")
    q = np.asarray(create_query_batch(1, 256, seed=103)[0])
    i1, v1 = map(np.asarray, eng.query(q))
    gi, gv = topk_exact(coo, q, 20)
    assert _precision(gi, i1) >= 0.95
    np.testing.assert_allclose(np.sort(v1), np.sort(gv), atol=1e-5)
