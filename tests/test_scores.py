"""Scores path: plain SpMV parity on every bucketed configuration.

Parity target: the reference's SpMV-only hosts that materialize the full
result vector (/root/reference/src/gpu/host_spmv_csr_gpu.cu:171-231),
checked against spmv_gold (:206-213). TopKSpMV.scores() is the sweep's
score stage, so it must cover the production configuration too:
width_quantum=2 + h16 + load()ed snapshots.
"""

import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sample_vector, create_sparse_matrix
from spmv_topk.formats.coo import CooMatrix
from spmv_topk.ops.fixedpoint import quantize_bf16
from spmv_topk.ops.gold import spmv_exact


def _bf16_oracle(coo):
    return CooMatrix(coo.rows, coo.cols, quantize_bf16(coo.vals),
                     coo.num_rows, coo.num_cols)


def _h16_oracle(coo, value_scale):
    v6 = np.clip(np.rint(coo.vals / value_scale), -31, 31) * value_scale
    return CooMatrix(coo.rows, coo.cols, v6.astype(np.float32),
                     coo.num_rows, coo.num_cols)


def test_scores_production_config_quantum2_h16():
    """The production config (h16 + quantum-2 + rescore) can produce dense
    scores: 6-bit matrix values times the f32 query, summed in f32."""
    coo = create_sparse_matrix(2000, 512, 20, "gamma", seed=70)
    cfg = TopKSpMVConfig(k=50, max_cols=512, query_codec="h16",
                         width_quantum=2, rescore_pool=200)
    eng = TopKSpMV(coo, cfg)
    q = create_sample_vector(512, seed=71)
    s = eng.scores(q)
    ref = spmv_exact(_h16_oracle(coo, eng._value_scale), q)
    np.testing.assert_allclose(s, ref, atol=1e-5)
    # ranking sanity: 6-bit values keep the top rows close to exact
    exact = spmv_exact(coo, q)
    assert len(set(np.argsort(-s)[:20]) & set(np.argsort(-exact)[:20])) >= 16


def test_scores_quantum2_f32_exact():
    coo = create_sparse_matrix(1500, 256, 7, "gamma", seed=72)
    cfg = TopKSpMVConfig(max_cols=256, width_quantum=2)
    eng = TopKSpMV(coo, cfg)
    q = create_sample_vector(256, seed=73)
    np.testing.assert_allclose(eng.scores(q), spmv_exact(_bf16_oracle(coo), q),
                               atol=1e-5)


def test_scores_wide_slices():
    """Hub rows much wider than the rest land in their own wide bucket."""
    coo = create_sparse_matrix(700, 1024, 12, "uniform", seed=76)
    hub_rows = np.repeat(np.arange(4, dtype=np.int32), 900)
    rng = np.random.default_rng(77)
    hub_cols = rng.integers(0, 1024, hub_rows.size).astype(np.int32)
    hub_vals = rng.random(hub_rows.size, dtype=np.float32) * 0.05
    coo = CooMatrix(np.concatenate([coo.rows, hub_rows]),
                    np.concatenate([coo.cols, hub_cols]),
                    np.concatenate([coo.vals, hub_vals]),
                    coo.num_rows, coo.num_cols).sort_row_major()
    eng = TopKSpMV(coo, TopKSpMVConfig(max_cols=1024))
    assert max(b.width for b in eng.sell.buckets) >= 900
    q = create_sample_vector(1024, seed=78)
    np.testing.assert_allclose(eng.scores(q), spmv_exact(_bf16_oracle(coo), q),
                               atol=1e-5)


def test_scores_empty_rows_stay_zero():
    """Rows with no nnz must score exactly 0 (SELL keeps them legal)."""
    rows = np.array([1, 1, 5, 5, 5], np.int32)
    cols = np.array([0, 3, 1, 2, 100], np.int32)
    vals = np.ones(5, np.float32)
    coo = CooMatrix(rows, cols, vals, 200, 128)
    eng = TopKSpMV(coo, TopKSpMVConfig(max_cols=128))
    q = np.ones(128, np.float32)
    s = eng.scores(q)
    assert s[1] == pytest.approx(2.0) and s[5] == pytest.approx(3.0)
    mask = np.ones(200, bool)
    mask[[1, 5]] = False
    assert np.all(s[mask] == 0.0)
