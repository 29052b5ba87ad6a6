"""Host merge oracle + fixed-point end-to-end tests."""

import numpy as np

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig, FIXED8
from spmv_topk.formats import CooMatrix, create_sparse_matrix, create_sample_vector
from spmv_topk.ops.fixedpoint import quantize_fixed
from spmv_topk.ops.gold import topk_exact
from spmv_topk.topk import merge_candidates_host


def test_merge_candidates_host_dedupe_and_order():
    idx = [np.array([3, 1, 5]), np.array([1, 7, -1])]
    val = [np.array([0.5, 0.9, 0.1]), np.array([0.8, 0.7, 9.9])]
    mi, mv = merge_candidates_host(idx, val, 3)
    assert mi.tolist() == [1, 7, 3]       # 1 deduped to max 0.9; -1 dropped
    np.testing.assert_allclose(mv, [0.9, 0.7, 0.5])


def test_fixed8_is_bit_exact_end_to_end():
    """ap_ufixed<8,1,AP_TRN_ZERO> values survive the bf16 container, so the
    engine reproduces the fixed-point gold exactly (the FPGA numerical-
    parity regime, fpga_types.hpp:16-23)."""
    coo = create_sparse_matrix(1000, 256, 10, "uniform", seed=90)
    qvals = quantize_fixed(coo.vals, 8, 1)
    qcoo = CooMatrix(coo.rows, coo.cols, qvals, coo.num_rows, coo.num_cols)
    cfg = TopKSpMVConfig(k=20, max_cols=256, value_format=FIXED8)
    eng = TopKSpMV(coo, cfg)
    q = create_sample_vector(256, seed=91)
    ki, kv = map(np.asarray, eng.query(q))
    gi, gv = topk_exact(qcoo, q, 20)
    assert set(ki.tolist()) == set(gi.tolist())
    np.testing.assert_allclose(np.sort(kv), np.sort(gv), atol=1e-6)
