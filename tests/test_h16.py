"""h16 codec: 2 nnz per 32-bit word (10-bit col + 6-bit value halves).

The analog of the reference's reduced-precision BSCSR packets — the
20-bit build raises nnz per 512-bit packet from 11 to 15
(types.hpp:61-73); h16 halves the bytes streamed per nnz outright. Values
are 6-bit signed with one global scale; the query stays f32, and the
production pairing is h16 + rescore_pool (exact host re-ranking).
"""

import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import CooMatrix, create_sparse_matrix, create_sample_vector
from spmv_topk.formats.sell_buckets import pack_sell_buckets
from spmv_topk.formats.synthetic import create_query_batch
from spmv_topk.ops.gold import topk_exact


def _precision(a, b):
    a = np.asarray(a).tolist(); b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def test_h16_pack_roundtrip():
    """Decode the paired words back into a dense matrix and compare with
    direct 6-bit quantization."""
    coo = create_sparse_matrix(700, 512, 9, "gamma", seed=110)  # odd degrees
    cfg = TopKSpMVConfig(k=10, max_cols=512, query_codec="h16")
    m = pack_sell_buckets(coo, cfg)
    vs = m.value_scale
    dense = np.zeros((coo.num_rows, coo.num_cols), np.float64)
    for b in m.buckets:
        for s in range(b.num_slices):
            t = b.slice_base + s
            rows = m.row_ids[t]
            blk = b.words[s].view(np.uint32)
            for half_shift in (0, 16):
                h = (blk >> half_shift) & 0xFFFF
                col = h & 0x3FF
                v6 = ((h >> 10) & 0x3F).astype(np.int64)
                v6 = np.where(v6 >= 32, v6 - 64, v6)
                for lane in range(128):
                    r = rows[lane]
                    if r < 0:
                        continue
                    nz = v6[:, lane] != 0
                    # add.at: the generator can emit duplicate (row, col)
                    # entries and fancy-index += drops repeats
                    np.add.at(dense[r], col[:, lane][nz],
                              v6[:, lane][nz] * vs)
    want = np.zeros_like(dense)
    v6_direct = np.clip(np.rint(coo.vals / vs), -31, 31)
    np.add.at(want, (coo.rows, coo.cols), v6_direct * vs)
    np.testing.assert_allclose(dense, want, atol=1e-12)


@pytest.mark.parametrize("dist", ["uniform", "gamma"])
def test_h16_engine_vs_exact(dist):
    coo = create_sparse_matrix(1500, 512, 14, dist, seed=111)
    q = create_sample_vector(512, seed=112)
    gi, gv = topk_exact(coo, q, 40)

    eng = TopKSpMV(coo, TopKSpMVConfig(k=40, max_cols=512,
                                       query_codec="h16"))
    ri, rv = map(np.asarray, eng.query(q))
    assert _precision(gi, ri) >= 0.75          # raw quantized ranking
    # quantized scores approximate the exact ones (global scales applied)
    both = set(gi.tolist()) & set(ri.tolist())
    gd = dict(zip(gi.tolist(), gv.tolist()))
    rd = dict(zip(ri.tolist(), rv.tolist()))
    err = max(abs(gd[r] - rd[r]) / max(abs(gd[r]), 1e-6) for r in both)
    assert err < 0.2

    # production mode: rescore restores exact ranking
    prod = TopKSpMV(coo, TopKSpMVConfig(k=40, max_cols=512,
                                        query_codec="h16",
                                        rescore_pool=200))
    pi, pv = map(np.asarray, prod.query(q))
    assert _precision(gi, pi) >= 0.97
    np.testing.assert_allclose(np.sort(pv), np.sort(gv), rtol=1e-5)


def test_h16_query_batch():
    coo = create_sparse_matrix(1200, 512, 10, "gamma", seed=113)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=20, max_cols=512,
                                       query_codec="h16",
                                       rescore_pool=100))
    Q = create_query_batch(3, 512, seed=114)
    bi, bv = map(np.asarray, eng.query_batch(Q, group_size=2))
    assert bi.shape == (3, 20)
    for qi in range(3):
        gi, gv = topk_exact(coo, Q[qi], 20)
        assert _precision(gi, bi[qi]) >= 0.95
        np.testing.assert_allclose(np.sort(bv[qi]), np.sort(gv), rtol=1e-5)


def test_h16_save_load_value_scale(tmp_path):
    coo = create_sparse_matrix(600, 256, 8, "uniform", seed=115)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=15, max_cols=256,
                                       query_codec="h16"))
    p = str(tmp_path / "h16.npz")
    eng.save(p)
    loaded = TopKSpMV.load(p)
    assert loaded._value_scale == pytest.approx(eng._value_scale)
    q = create_sample_vector(256, seed=116)
    a, av = map(np.asarray, eng.query(q))
    b, bv = map(np.asarray, loaded.query(q))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(av, bv, rtol=1e-6)


def test_h16_sharded():
    import jax

    from spmv_topk.parallel import make_mesh
    from spmv_topk.parallel.sharded_buckets import ShardedBucketedTopKSpMV

    mesh = make_mesh(jax.devices()[:4])
    coo = create_sparse_matrix(2000, 512, 10, "gamma", seed=117)
    cfg = TopKSpMVConfig(k=25, max_cols=512, query_codec="h16",
                         rescore_pool=125)
    eng = ShardedBucketedTopKSpMV(coo, cfg, mesh=mesh)
    q = create_sample_vector(512, seed=118)
    ki, kv = map(np.asarray, eng.query(q))
    gi, gv = topk_exact(coo, q, 25)
    assert _precision(gi, ki) >= 0.95
    np.testing.assert_allclose(np.sort(kv), np.sort(gv), rtol=1e-5)
