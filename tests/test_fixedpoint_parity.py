"""Fixed-point differential parity at the reference's widths.

The reference stores matrix values as ap_ufixed<FIXED_WIDTH, 1,
AP_TRN_ZERO> (/root/reference/src/fpga/src/ip/fpga_types.hpp:16-23;
FIXED_WIDTH sweep /root/reference/src/common/types.hpp:20-27) and checks
hardware output against the gold with index tolerance 0 and value
tolerance 1e-5 (/root/reference/src/fpga/src/host_spmv_bscsr.cpp:638-663).
These tests run the packet-accurate gold AND a real kernel config under
ValueFormat("fixed", ...) against that tolerance regime.
"""

import dataclasses

import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig, ValueFormat
from spmv_topk.formats import (create_sample_vector,
                                   create_sparse_matrix, pack_bscsr)
from spmv_topk.formats.coo import CooMatrix
from spmv_topk.ops import gold
from spmv_topk.ops.fixedpoint import quantize_bf16, quantize_fixed


def _quantized(coo: CooMatrix, width: int) -> CooMatrix:
    return CooMatrix(coo.rows, coo.cols, quantize_fixed(coo.vals, width),
                     coo.num_rows, coo.num_cols)


@pytest.mark.parametrize("width", [8, 16, 32])
def test_packet_gold_fixed_point_parity(width):
    """Packet gold on ap_ufixed-quantized values vs exact top-k on the
    same values: idx tol 0, val tol 1e-5 (the reference regime)."""
    coo = create_sparse_matrix(700, 256, 9, "uniform", seed=30)
    q = create_sample_vector(256, seed=31)
    qcoo = _quantized(coo, width)
    gi, gv = gold.topk_exact(qcoo, q, 12)
    parts = pack_bscsr(qcoo, num_partitions=1, packet_size=11)
    pi, pv = gold.topk_bscsr_packet_gold(parts[0], q, 12)
    order = np.argsort(-pv, kind="stable")
    np.testing.assert_array_equal(pi[order], gi)            # tol 0
    np.testing.assert_allclose(pv[order], gv, atol=1e-5)    # tol 1e-5


def test_fixed8_is_bit_exact_in_the_bf16_container():
    """<= 9 significant bits survive the bf16 word layout exactly, so
    ValueFormat("fixed", 8) gives bit-exact ap_ufixed<8,1> storage."""
    rng = np.random.default_rng(32)
    vals = rng.random(4096, dtype=np.float32) * 1.9
    q8 = quantize_fixed(vals, 8)
    np.testing.assert_array_equal(quantize_bf16(q8), q8)


@pytest.mark.parametrize("width", [8, 32])
def test_kernel_fixed_point_parity(width):
    """End-to-end engine under ValueFormat("fixed", width) vs the exact
    gold computed on the SAME container-quantized values: idx tol 0 after
    sorting, val tol 1e-5. width=8 is bit-exact in the bf16 container;
    width=32 additionally rounds to bf16 at pack (documented container
    limit), so its oracle quantizes the same way."""
    coo = create_sparse_matrix(3000, 256, 10, "uniform", seed=33)
    q = create_sample_vector(256, seed=34)
    fmt = ValueFormat("fixed", fixed_width=width)
    cfg = TopKSpMVConfig(k=20, lane_k=8, max_cols=256, value_format=fmt)
    eng = TopKSpMV(coo, cfg)
    ki, kv = map(np.asarray, eng.query(q))

    vq = quantize_fixed(coo.vals, width)
    if width > 9:  # what the bf16 word container actually stores
        vq = quantize_bf16(vq)
    gi, gv = gold.topk_exact(
        CooMatrix(coo.rows, coo.cols, vq, coo.num_rows, coo.num_cols), q, 20)
    np.testing.assert_array_equal(ki, gi)                   # tol 0
    np.testing.assert_allclose(kv, gv, atol=1e-5)           # tol 1e-5


def test_fixed_width_sweep_accuracy_degrades_gracefully():
    """The FIXED_WIDTH accuracy knob (types.hpp:20-27): narrower fixed
    point degrades precision monotonically-ish but stays useful at 8 bits
    (the reference ships 20-26 bit builds; plot_errors.py analyzes the
    precision cost)."""
    coo = create_sparse_matrix(4000, 256, 10, "gamma", seed=35)
    q = create_sample_vector(256, seed=36)
    gi, _ = gold.topk_exact(coo, q, 50)
    prec = {}
    for width in (6, 8, 16):
        fmt = ValueFormat("fixed", fixed_width=width)
        cfg = TopKSpMVConfig(k=50, lane_k=8, max_cols=256, value_format=fmt)
        eng = TopKSpMV(coo, cfg)
        ki = np.asarray(eng.query(q)[0])
        prec[width] = len(set(ki.tolist()) & set(gi.tolist())) / 50
    assert prec[16] >= prec[6]
    assert prec[8] >= 0.8
    assert prec[16] >= 0.95
