"""Exact-rescore serving mode: reduced-precision sweep + host CSR re-ranking.

The device sweep over h16 words (6-bit matrix values, half the bytes
per nnz) proposes a widened candidate pool; the exact f32 re-ranking on
the host CSR restores the true top-k — the engine's analog of the
reference's host merge being the accuracy backstop over per-partition
approximation (host_spmv_bscsr.cpp:399-448, topk_errors.py:29-42).
"""

import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix, create_sample_vector
from spmv_topk.formats.synthetic import create_query_batch
from spmv_topk.ops.gold import topk_exact


def _precision(a, b):
    a = np.asarray(a).tolist(); b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def test_rescore_restores_exact_ranking_h16():
    coo = create_sparse_matrix(3000, 1024, 16, "gamma", seed=90)
    q = create_sample_vector(1024, seed=91)
    gi, gv = topk_exact(coo, q, 50)

    eng = TopKSpMV(coo, TopKSpMVConfig(k=50, query_codec="h16",
                                       rescore_pool=250))
    ri, rv = eng.query(q)
    assert _precision(gi, ri) >= 0.98
    # rescored values are exact f32 dot products
    np.testing.assert_allclose(np.sort(rv), np.sort(gv), rtol=1e-5)

    # raw h16 (pool disabled per call) ranks strictly worse or equal
    raw_i, _ = eng.query(q, rescore_pool=0)
    assert _precision(gi, ri) >= _precision(gi, np.asarray(raw_i))


def test_rescore_batch():
    coo = create_sparse_matrix(2000, 512, 12, "uniform", seed=92)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=512,
                                       query_codec="h16", rescore_pool=100))
    Q = create_query_batch(3, 512, seed=93)
    bi, bv = map(np.asarray, eng.query_batch(Q, group_size=2))
    assert bi.shape == (3, 25)
    for qi in range(3):
        gi, gv = topk_exact(coo, Q[qi], 25)
        assert _precision(gi, bi[qi]) >= 0.96
        np.testing.assert_allclose(np.sort(bv[qi]), np.sort(gv), rtol=1e-5)


def test_rescore_pool_smaller_than_k_is_clamped():
    coo = create_sparse_matrix(800, 256, 8, "uniform", seed=94)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=256,
                                       rescore_pool=10))
    q = create_sample_vector(256, seed=95)
    idx, vals = eng.query(q)
    assert len(idx) == 30
    gi, _ = topk_exact(coo, q, 30)
    assert _precision(gi, idx) >= 0.9


def test_loaded_engine_disables_rescore(tmp_path):
    """A snapshot has no host CSR: load() warns and serves un-rescored
    rather than arming a crash in the default query() path."""
    coo = create_sparse_matrix(500, 256, 8, "uniform", seed=96)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=10, max_cols=256,
                                       rescore_pool=50))
    p = str(tmp_path / "eng.npz")
    eng.save(p)
    with pytest.warns(UserWarning, match="rescore_pool disabled"):
        loaded = TopKSpMV.load(p)
    assert loaded.config.rescore_pool is None
    q = create_sample_vector(256, seed=97)
    idx, _ = loaded.query(q)        # default path works, un-rescored
    assert len(np.asarray(idx)) == 10
    with pytest.raises(NotImplementedError):
        loaded.query(q, rescore_pool=50)  # explicit request still errors


def test_dense_engine_rescore():
    from spmv_topk.ops.dense import DenseTopKSpMV

    coo = create_sparse_matrix(2000, 256, 10, "gamma", seed=98)
    eng = DenseTopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=256,
                                            rescore_pool=100),
                        hbm_budget_bytes=1 << 30)
    q = create_sample_vector(256, seed=99)
    ri, rv = map(np.asarray, eng.query(q))
    gi, gv = topk_exact(coo, q, 25)
    assert _precision(gi, ri) >= 0.96
    np.testing.assert_allclose(np.sort(rv), np.sort(gv), rtol=1e-5)


def test_sharded_oversized_pool_clamps_and_oversized_k_raises():
    import jax

    from spmv_topk.parallel import make_mesh
    from spmv_topk.parallel.sharded_buckets import ShardedBucketedTopKSpMV

    mesh = make_mesh(jax.devices()[:2])
    coo = create_sparse_matrix(1200, 256, 8, "uniform", seed=100)
    # pool larger than the per-device candidate pool (lane_k*128=1024):
    # the device merge clamps, the rescore pads to k
    cfg = TopKSpMVConfig(k=20, max_cols=256, query_codec="h16",
                         rescore_pool=2000)
    eng = ShardedBucketedTopKSpMV(coo, cfg, mesh=mesh)
    q = create_sample_vector(256, seed=101)
    ki, kv = map(np.asarray, eng.query(q))
    assert ki.shape == (20,)
    gi, _ = topk_exact(coo, q, 20)
    assert _precision(gi, ki) >= 0.95
    with pytest.raises(ValueError, match="merge width"):
        eng.query(q, k=4000)
    with pytest.raises(ValueError, match="merge width"):
        eng.query_batch(np.stack([q]), k=4000)


def test_exact_rescore_handles_empty_rows():
    """cumsum-difference segment sums: rows with zero nnz score 0."""
    from spmv_topk.formats import CooMatrix
    from spmv_topk.api import exact_rescore

    rows = np.array([0, 0, 2], np.int32)    # row 1 and 3 empty
    cols = np.array([0, 3, 1], np.int32)
    vals = np.array([2.0, 1.0, 5.0], np.float32)
    csr = CooMatrix(rows, cols, vals, 4, 4).to_scipy()
    vec = np.ones(4, np.float32)
    idx = np.array([3, 2, 1, 0, -1], np.int32)   # incl. padding sentinel
    oi, ov = exact_rescore(csr, idx, vec, 4)
    np.testing.assert_array_equal(oi[:2], [2, 0])
    assert set(oi[2:].tolist()) == {1, 3}       # zero-score ties
    np.testing.assert_allclose(ov, [5.0, 3.0, 0.0, 0.0])
