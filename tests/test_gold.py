"""Gold-oracle tests: streaming and packet-accurate Top-K golds vs exact.

The reference validates hardware against spmv_coo_gold_top_k and uses
spmv_coo_gold_top_k_packet as an algorithm-level mock of the packet
pipeline (gold_algorithms.hpp:189-362). Here both golds are themselves
tested against the argsort ground truth.
"""

import numpy as np
import pytest

from spmv_topk.config import ValueFormat
from spmv_topk.formats import create_sparse_matrix, create_sample_vector, pack_bscsr
from spmv_topk.ops import gold
from spmv_topk.ops.fixedpoint import quantize_fixed, quantize_bf16


def _precision(a, b):
    return len(set(np.asarray(a).tolist()) & set(np.asarray(b).tolist())) / len(a)


def test_spmv_exact_matches_scipy():
    coo = create_sparse_matrix(500, 256, 10, "uniform", seed=0)
    q = create_sample_vector(256, seed=1)
    ref = coo.to_scipy() @ q
    np.testing.assert_allclose(gold.spmv_exact(coo, q), ref, rtol=1e-5)


def test_streaming_gold_matches_exact():
    coo = create_sparse_matrix(800, 256, 10, "uniform", seed=2)
    q = create_sample_vector(256, seed=3)
    gi, gv = gold.topk_exact(coo, q, 16)
    si, sv = gold.topk_streaming_gold(coo, q, 16)
    assert _precision(gi, si) == 1.0
    np.testing.assert_allclose(sorted(sv), sorted(gv), rtol=1e-5)


@pytest.mark.parametrize("packet_size", [4, 11])
def test_packet_gold_matches_exact_with_full_lfr(packet_size):
    coo = create_sparse_matrix(600, 256, 9, "uniform", seed=4)
    q = create_sample_vector(256, seed=5)
    gi, gv = gold.topk_exact(coo, q, 12)
    parts = pack_bscsr(coo, num_partitions=1, packet_size=packet_size)
    pi, pv = gold.topk_bscsr_packet_gold(parts[0], q, 12)
    assert _precision(gi, pi) == 1.0
    np.testing.assert_allclose(sorted(pv), sorted(gv), rtol=1e-5)


def test_packet_gold_lfr_is_an_approximation():
    """LIMITED_FINISHED_ROWS drops rows, degrading (not destroying) recall
    (types.hpp:75-77; the accuracy cost documented in plot_errors.py)."""
    coo = create_sparse_matrix(600, 256, 3, "gamma", seed=6)
    q = create_sample_vector(256, seed=7)
    gi, _ = gold.topk_exact(coo, q, 12)
    parts = pack_bscsr(coo, num_partitions=1, packet_size=11)
    pi_full, _ = gold.topk_bscsr_packet_gold(parts[0], q, 12)
    pi_lfr, _ = gold.topk_bscsr_packet_gold(parts[0], q, 12, limited_finished_rows=2)
    assert _precision(gi, pi_full) == 1.0
    assert 0.3 <= _precision(gi, pi_lfr) <= 1.0


def test_multipartition_gold_merge():
    coo = create_sparse_matrix(1000, 256, 8, "uniform", seed=8)
    q = create_sample_vector(256, seed=9)
    gi, gv = gold.topk_exact(coo, q, 10)
    parts = pack_bscsr(coo, num_partitions=4, packet_size=11)
    # per-partition top-k then merge, like read_result (host_spmv_bscsr.cpp:399-448)
    cand_i, cand_v = [], []
    for p in parts:
        i, v = gold.topk_bscsr_packet_gold(p, q, 10)
        cand_i.append(i); cand_v.append(v)
    ci = np.concatenate(cand_i); cv = np.concatenate(cand_v)
    order = np.argsort(-cv)[:10]
    assert _precision(gi, ci[order]) == 1.0


def test_fixed_point_quantizer_matches_ap_ufixed():
    vals = np.array([0.0, 0.1, 0.999999, 1.0 - 2**-31, 0.5 + 2**-32], np.float32)
    q31 = quantize_fixed(vals, 32, 1)  # ap_ufixed<32,1,AP_TRN_ZERO>
    scale = 2.0 ** 31
    np.testing.assert_array_equal(q31, np.float32(np.trunc(vals.astype(np.float64) * scale) / scale))
    q8 = quantize_fixed(np.array([0.7], np.float32), 8, 1)
    assert q8[0] == np.float32(np.trunc(0.7 * 128) / 128)


def test_bf16_quantizer_round_nearest_even():
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 2**-8, -0.3], np.float32)
    q = quantize_bf16(x)
    assert q[0] == 1.0
    assert q[1] in (1.0, np.float32(1.0 + 2**-8))
    assert abs(q[3] + 0.3) < 2e-3


def test_pagerank_gold_converges():
    """Legacy PageRank parity (pagerank_golden, gold_algorithms.hpp:397)."""
    import numpy as np
    from spmv_topk.formats.coo import CooMatrix

    rng = np.random.default_rng(80)
    n = 50
    rows = rng.integers(0, n, 400).astype(np.int32)
    cols = rng.integers(0, n, 400).astype(np.int32)
    # column-stochastic transition matrix
    vals = np.ones(400, dtype=np.float32)
    coo = CooMatrix(rows, cols, vals, n, n).sort_row_major()
    colsum = np.bincount(coo.cols, coo.vals, minlength=n)
    vals = coo.vals / np.maximum(colsum[coo.cols], 1)
    coo = CooMatrix(coo.rows, coo.cols, vals, n, n)
    pr, iters = gold.pagerank_gold(coo, max_iter=200)
    assert iters < 200
    assert abs(pr.sum() - 1.0) < 0.05
