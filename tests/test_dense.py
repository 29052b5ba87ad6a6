"""Dense batch engine (ops/dense.py) vs the exact gold."""

import numpy as np
import pytest

import spmv_topk as st
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import (
    create_sparse_matrix, create_query_batch, create_sample_vector)
from spmv_topk.ops.dense import densify_bf16
from spmv_topk.ops.gold import topk_exact


def _precision(a, b):
    a = np.asarray(a).tolist()
    b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def test_densify_bf16_roundtrip():
    coo = create_sparse_matrix(600, 256, 8, "uniform", seed=97)
    bits = densify_bf16(coo, row_block=200)
    dense = (bits.astype(np.uint32) << 16).view(np.float32)
    ref = coo.to_scipy().toarray().astype(np.float32)
    # truncation to bf16: relative error < 2^-8
    assert np.abs(dense - ref).max() <= np.abs(ref).max() * 2**-8


def test_dense_engine_vs_exact():
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=95)
    eng = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=40, max_cols=512),
                           block_rows=2048, hbm_budget_bytes=1 << 30)
    Q = create_query_batch(4, 512, seed=96)
    bi, bv = map(np.asarray, eng.query_batch(Q))
    for i in range(4):
        gi, gv = topk_exact(coo, Q[i], 40)
        assert _precision(gi, bi[i]) >= 0.9
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(gv), atol=5e-3)


def test_dense_engine_single_query_parity():
    coo = create_sparse_matrix(3000, 256, 10, "uniform", seed=98)
    eng = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=256),
                           block_rows=1024, hbm_budget_bytes=1 << 30)
    q = create_sample_vector(256, seed=99)
    i1, v1 = map(np.asarray, eng.query(q))
    gi, _ = topk_exact(coo, q, 25)
    assert _precision(gi, i1) >= 0.9


def test_densify_int8_roundtrip():
    from spmv_topk.ops.dense import densify_int8

    coo = create_sparse_matrix(600, 256, 8, "uniform", seed=97)
    bits, scales = densify_int8(coo, row_block=200)
    dense = bits.astype(np.float32) * scales[:, None]
    ref = coo.to_scipy().toarray().astype(np.float32)
    # symmetric per-row int8: error <= scale/2 = max|row|/254 per entry
    row_max = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(dense - ref) <= row_max / 254 + 1e-7)


def test_dense_engine_int8_vs_exact():
    """int8 per-row-scale engine: raw ranking close to exact; values
    dequantized (row scale x query scale) back to dot-product units."""
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=95)
    eng = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=40, max_cols=512),
                           block_rows=2048, hbm_budget_bytes=1 << 30,
                           dtype="int8")
    Q = create_query_batch(4, 512, seed=96)
    bi, bv = map(np.asarray, eng.query_batch(Q))
    for i in range(4):
        gi, gv = topk_exact(coo, Q[i], 40)
        assert _precision(gi, bi[i]) >= 0.85
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(gv), atol=2e-2)


def test_dense_engine_int8_rescore_exact():
    """int8 + exact host rescore: production serving configuration."""
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=95)
    eng = st.DenseTopKSpMV(
        coo, TopKSpMVConfig(k=40, max_cols=512, rescore_pool=200),
        block_rows=2048, hbm_budget_bytes=1 << 30, dtype="int8")
    Q = create_query_batch(2, 512, seed=96)
    bi, bv = map(np.asarray, eng.query_batch(Q))
    for i in range(2):
        gi, gv = topk_exact(coo, Q[i], 40)
        assert _precision(gi, bi[i]) >= 0.97
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(gv), atol=1e-5)


def test_dense_int8_halves_hbm():
    coo = create_sparse_matrix(3000, 256, 10, "uniform", seed=98)
    e8 = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=256),
                          block_rows=1024, hbm_budget_bytes=1 << 30,
                          dtype="int8")
    e16 = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=256),
                           block_rows=1024, hbm_budget_bytes=1 << 30)
    assert e8.hbm_bytes * 2 == e16.hbm_bytes


def test_dense_engine_memory_guard():
    coo = create_sparse_matrix(3000, 256, 10, "uniform", seed=98)
    with pytest.raises(ValueError):
        st.DenseTopKSpMV(coo, TopKSpMVConfig(k=25, max_cols=256),
                         hbm_budget_bytes=1000)


def test_dense_pad_rows_do_not_displace_negative_scores():
    """Pad rows in the last block score exactly 0 from zero vectors; with
    all-negative real scores they must not displace real rows."""
    rng = np.random.default_rng(120)
    n, c, d = 1100, 256, 6          # 1100 rows -> pads to 2048 at block 1024
    rows = np.repeat(np.arange(n, dtype=np.int32), d)
    cols = np.concatenate(
        [rng.choice(c, d, replace=False) for _ in range(n)]).astype(np.int32)
    vals = -np.abs(rng.standard_normal(n * d)).astype(np.float32)
    from spmv_topk.formats import CooMatrix
    coo = CooMatrix(rows, cols, vals, n, c).sort_row_major()
    q = np.abs(rng.standard_normal(c)).astype(np.float32)  # scores all < 0
    eng = st.DenseTopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=256),
                           block_rows=1024, hbm_budget_bytes=1 << 30)
    idx, vals_out = map(np.asarray, eng.query(q))
    assert np.all(idx >= 0), "pad rows leaked into the top-k"
    assert np.all(vals_out < 0)
    gi, _ = topk_exact(coo, q, 30)
    assert _precision(gi, idx) >= 0.9
