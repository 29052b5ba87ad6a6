"""Bucketed uniform-W layout tests (plain-JAX sweep on the CPU)."""

import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import CooMatrix, create_sparse_matrix, create_sample_vector
from spmv_topk.formats.sell_buckets import pack_sell_buckets
from spmv_topk.ops.fixedpoint import quantize_bf16
from spmv_topk.ops.gold import topk_exact


def _precision(a, b):
    a = np.asarray(a).tolist(); b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def test_bucket_structure():
    coo = create_sparse_matrix(4000, 512, 16, "gamma", seed=50)
    m = pack_sell_buckets(coo, TopKSpMVConfig(max_cols=512))
    # buckets cover all slices contiguously, widths strictly decreasing
    assert m.buckets[0].slice_base == 0
    total = 0
    widths = []
    for b in m.buckets:
        assert b.slice_base == total
        assert b.width % 8 == 0 and b.words.shape == (b.num_slices, b.width,
                                                      128)
        total += b.num_slices
        widths.append(b.width)
    assert total == m.num_slices
    assert widths == sorted(widths, reverse=True)
    # every row appears once; only the last slice has padding lanes
    ids = m.row_ids
    assert sorted(ids[ids >= 0].tolist()) == list(range(coo.num_rows))
    assert np.all(ids[:-1] >= 0)


@pytest.mark.parametrize("dist", ["uniform", "gamma"])
def test_bucketed_engine_vs_exact(dist):
    coo = create_sparse_matrix(1300, 512, 14, dist, seed=51)
    qcoo = CooMatrix(coo.rows, coo.cols, quantize_bf16(coo.vals),
                     coo.num_rows, coo.num_cols)
    cfg = TopKSpMVConfig(k=40, max_cols=512)
    eng = TopKSpMV(coo, cfg)
    for trial in range(1):
        q = create_sample_vector(512, seed=500 + trial)
        ki, kv = map(np.asarray, eng.query(q))
        gi, gv = topk_exact(qcoo, q, 40)
        assert _precision(gi, ki) == 1.0
        np.testing.assert_allclose(np.sort(kv), np.sort(gv), atol=1e-5)


def test_bucketed_negative_scores_block_padding():
    """Padding lanes (score 0) must not displace real negative
    candidates."""
    rng = np.random.default_rng(52)
    n = 300  # non-multiple of 128 -> padded lanes
    rows = np.repeat(np.arange(n, dtype=np.int32), 4)
    cols = rng.integers(0, 256, len(rows)).astype(np.int32)
    vals = (-np.abs(rng.standard_normal(len(rows)))).astype(np.float32)
    coo = CooMatrix(rows, cols, vals, n, 256).sort_row_major()
    q = np.abs(rng.standard_normal(256)).astype(np.float32)  # scores all < 0
    # lane_k=1: each lane keeps one of its 3 slices, so an unmasked
    # padding lane (score 0) would take the slot of every real row in
    # the 84 lanes whose last slice is padding
    cfg = TopKSpMVConfig(k=64, lane_k=1, max_cols=256)
    eng = TopKSpMV(coo, cfg)
    ki, kv = map(np.asarray, eng.query(q))
    assert np.all(np.isfinite(kv)) and np.all(kv < 0)
    assert len(set(ki.tolist())) == 64
    assert np.all(ki >= 0) and np.all(ki < n)


def test_query_batch_grouped_kernel():
    from spmv_topk.formats import create_query_batch

    coo = create_sparse_matrix(900, 512, 12, "gamma", seed=56)
    cfg = TopKSpMVConfig(k=15, max_cols=512)
    eng = TopKSpMV(coo, cfg)
    Q = create_query_batch(5, 512, seed=57)  # forces a padded tail group
    bi, bv = map(np.asarray, eng.query_batch(Q, k=15, group_size=4))
    assert bi.shape == (5, 15)
    for qi in (0, 1, 4):
        si, sv = map(np.asarray, eng.query(Q[qi], k=15))
        assert _precision(si, bi[qi]) == 1.0
        np.testing.assert_allclose(np.sort(bv[qi]), np.sort(sv), atol=1e-6)


def test_scores_plain_spmv():
    from spmv_topk.ops.gold import spmv_exact
    from spmv_topk.ops.fixedpoint import quantize_bf16

    coo = create_sparse_matrix(900, 256, 10, "gamma", seed=58)
    qcoo = CooMatrix(coo.rows, coo.cols, quantize_bf16(coo.vals),
                     coo.num_rows, coo.num_cols)
    cfg = TopKSpMVConfig(max_cols=256)
    eng = TopKSpMV(coo, cfg)
    q = create_sample_vector(256, seed=59)
    s = eng.scores(q)
    np.testing.assert_allclose(s, spmv_exact(qcoo, q), atol=1e-5)


def test_non_multiple_of_128_cols():
    """GloVe-like geometry: num_cols=300 pads to a 384-col table."""
    coo = create_sparse_matrix(1500, 300, 12, "uniform", seed=58)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=128))  # auto-raised
    assert eng.config.max_cols == 384
    q = create_sample_vector(300, seed=59)
    ki, kv = map(np.asarray, eng.query(q))
    gi, gv = topk_exact(coo, q, 30)
    assert _precision(gi, ki) == 1.0
    np.testing.assert_allclose(np.sort(kv), np.sort(gv), atol=2e-3)

    fast = TopKSpMV(coo, TopKSpMVConfig(k=30, max_cols=128,
                                        query_codec="h16", width_quantum=4,
                                        rescore_pool=120))
    fi, fv = map(np.asarray, fast.query(q))
    assert _precision(gi, fi) >= 0.96
