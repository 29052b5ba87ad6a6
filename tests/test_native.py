"""Native C++ runtime vs NumPy differential tests (runtime/spmv_runtime.cpp)."""

import numpy as np
import pytest

from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix, write_mtx
from spmv_topk.formats.sell_buckets import pack_sell_buckets
from spmv_topk.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime not built"
)


def test_native_mtx_parse_matches_python(tmp_path):
    coo = create_sparse_matrix(500, 256, 8, "gamma", seed=30)
    path = str(tmp_path / "n.mtx")
    write_mtx(path, coo)
    rows, cols, vals, nr, nc = native.mtx_parse(path)
    assert (nr, nc) == (500, 256)
    np.testing.assert_array_equal(rows, coo.rows)
    np.testing.assert_array_equal(cols, coo.cols)
    np.testing.assert_allclose(vals, coo.vals, rtol=1e-6)


def test_native_pack_equals_numpy_pack(monkeypatch):
    coo = create_sparse_matrix(3000, 512, 15, "gamma", seed=31)
    cfg = TopKSpMVConfig(max_cols=512, width_quantum=2)
    m_native = pack_sell_buckets(coo, cfg)
    # force the NumPy path
    monkeypatch.setattr(native, "sell_plan", lambda *a, **k: None)
    monkeypatch.setattr(native, "sell_scatter", lambda *a, **k: None)
    m_numpy = pack_sell_buckets(coo, cfg)
    assert len(m_native.buckets) == len(m_numpy.buckets)
    for bn, bp in zip(m_native.buckets, m_numpy.buckets):
        assert (bn.width, bn.slice_base) == (bp.width, bp.slice_base)
        np.testing.assert_array_equal(bn.words, bp.words)
    np.testing.assert_array_equal(m_native.row_ids, m_numpy.row_ids)


def test_native_sort_perm():
    rng = np.random.default_rng(32)
    rows = rng.integers(0, 100, 1000).astype(np.int32)
    cols = rng.integers(0, 64, 1000).astype(np.int32)
    perm = native.coo_sort_perm(rows, cols, 64)
    keys = rows.astype(np.int64) * 64 + cols
    assert np.all(np.diff(keys[perm]) >= 0)


def test_csr_rescore_matches_numpy_fallback():
    from spmv_topk.api import exact_rescore
    from spmv_topk.utils import native

    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=33)
    csr = coo.to_scipy()
    rng = np.random.default_rng(34)
    idx = rng.integers(0, 5000, 200).astype(np.int32)
    vec = rng.standard_normal(512).astype(np.float32)
    oi, ov = exact_rescore(csr, idx, vec, 50)
    if not native.available():
        pytest.skip("native runtime not built")
    # force the NumPy fallback and compare
    real = native.csr_rescore
    try:
        native.csr_rescore = lambda *a: None
        fi, fv = exact_rescore(csr, idx, vec, 50)
    finally:
        native.csr_rescore = real
    np.testing.assert_array_equal(oi, fi)
    np.testing.assert_allclose(ov, fv, rtol=2e-6)


def test_native_h16_scatter_matches_numpy(monkeypatch):
    """Native threaded pair-scatter vs the NumPy oracle, bucketed pack."""
    from spmv_topk.formats.sell_buckets import pack_sell_buckets

    coo = create_sparse_matrix(4000, 1024, 21, "gamma", seed=35)  # odd degs
    cfg = TopKSpMVConfig(query_codec="h16", rescore_pool=200)
    m_native = pack_sell_buckets(coo, cfg)
    monkeypatch.setattr(native, "h16_scatter", lambda *a, **k: None)
    m_numpy = pack_sell_buckets(coo, cfg)
    assert m_native.value_scale == m_numpy.value_scale
    assert len(m_native.buckets) == len(m_numpy.buckets)
    for bn, bp in zip(m_native.buckets, m_numpy.buckets):
        assert (bn.width, bn.slice_base) == (bp.width, bp.slice_base)
        np.testing.assert_array_equal(bn.words, bp.words)
    np.testing.assert_array_equal(m_native.row_ids, m_numpy.row_ids)


def test_native_cpu_topk_spmv_matches_scipy():
    """Native threaded CPU Top-K SpMV == scipy matvec + argsort oracle."""
    from spmv_topk.utils import native

    if not native.available():
        pytest.skip("native runtime not built")
    coo = create_sparse_matrix(5000, 512, 12, "gamma", seed=21)
    csr = coo.to_scipy()
    q = np.random.default_rng(22).standard_normal(512).astype(np.float32)
    k = 50
    out = native.cpu_topk_spmv(
        np.ascontiguousarray(csr.indptr, np.int64),
        np.ascontiguousarray(csr.indices, np.int32),
        np.ascontiguousarray(csr.data, np.float32), q, k)
    assert out is not None
    idx, val = out
    scores = csr @ q
    want = np.argsort(-scores, kind="stable")[:k]
    np.testing.assert_allclose(np.sort(val), np.sort(scores[want]),
                               rtol=1e-6)
    assert set(idx.tolist()) == set(want.tolist())
