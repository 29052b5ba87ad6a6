"""The plain-JAX sweep (ops/sweep.py) against the NumPy reference.

Every entry point — query, query_batch, scores, the sharded engine on 8
virtual devices, and save/load — is compared with `sell_scores_np`, a
NumPy re-statement of the sweep over the same packed words (the analog
of the reference's packet-accurate software model,
gold_algorithms.hpp:277-362), for both word formats, both degree
distributions and the layout's corner cases. lane_k is set above the
slice count, so the device answer is the exact Top-K of the packed
matrix; `test_lane_k_approximation_recall` covers the approximate regime.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import LANES, TopKSpMVConfig
from spmv_topk.formats import (CooMatrix, create_query_batch,
                               create_sample_vector, create_sparse_matrix)
from spmv_topk.formats.sell_buckets import pack_sell_buckets
from spmv_topk.ops.gold import topk_exact
from spmv_topk.ops.sweep import bucket_scores, lane_topk
from spmv_topk.ops.xla_ref import sell_scores_np, topk_spmv_segment_xla
from spmv_topk.parallel import ShardedBucketedTopKSpMV, make_mesh

K = 40


def _precision(a, b):
    a = np.asarray(a).tolist()
    b = np.asarray(b).tolist()
    return len(set(a) & set(b)) / len(a)


def _matrix(shape: str, dist: str, seed: int) -> CooMatrix:
    """Small corpora that exercise one corner of the layout each."""
    rng = np.random.default_rng(seed)
    if shape == "narrow":    # widths of 1-8 words: many tiny buckets
        return create_sparse_matrix(1500, 256, 4, dist, seed=seed)
    if shape == "wide":      # hub rows far wider than the rest
        base = create_sparse_matrix(1000, 1024, 12, dist, seed=seed)
        hub = np.repeat(np.arange(0, 1000, 97, dtype=np.int32), 600)
        return CooMatrix(
            np.concatenate([base.rows, hub]),
            np.concatenate([base.cols,
                            rng.integers(0, 1024, hub.size, dtype=np.int32)]),
            np.concatenate([base.vals,
                            rng.random(hub.size, dtype=np.float32) * 0.1]),
            base.num_rows, base.num_cols).sort_row_major()
    if shape == "empty_negative":  # every other row empty, signed values
        base = create_sparse_matrix(750, 512, 10, dist, seed=seed)
        vals = base.vals * np.where(rng.random(base.nnz) < 0.5, -1, 1)
        return CooMatrix(base.rows * 2, base.cols, vals.astype(np.float32),
                         1500, 512).sort_row_major()
    if shape == "padding":   # 77 padding lanes, odd degrees, all scores < 0
        base = create_sparse_matrix(1101, 384, 9, dist, seed=seed)
        return CooMatrix(base.rows, base.cols, -base.vals, base.num_rows,
                         base.num_cols).sort_row_major()
    raise ValueError(shape)


def _check_topk(idx, vals, ref_scores, k):
    """Device Top-K equals the reference's up to f32 rounding: the values
    match, and every returned row scores at least the k-th best (so rows
    tied at the rank boundary may swap)."""
    idx, vals = np.asarray(idx), np.asarray(vals)
    want = np.sort(ref_scores)[::-1][:k]
    assert len(set(idx.tolist())) == k and idx.min() >= 0
    np.testing.assert_allclose(np.sort(vals)[::-1], want, atol=1e-5)
    np.testing.assert_allclose(vals, ref_scores[idx], atol=1e-5)
    assert np.all(ref_scores[idx] >= want[-1] - 1e-5)


@pytest.mark.parametrize("path", ["single", "batch", "scores", "sharded",
                                  "saveload"])
@pytest.mark.parametrize("shape", ["narrow", "wide", "empty_negative",
                                   "padding"])
@pytest.mark.parametrize("dist", ["uniform", "gamma"])
@pytest.mark.parametrize("codec", ["f32", "h16"])
def test_engine_matches_reference(codec, dist, shape, path, tmp_path):
    coo = _matrix(shape, dist, seed=len(shape) * 7 + len(dist))
    cfg = TopKSpMVConfig(k=K, lane_k=16, max_cols=coo.num_cols,
                         query_codec=codec, width_quantum=2)
    eng = TopKSpMV(coo, cfg)
    assert eng.sell.num_slices <= cfg.lane_k
    queries = create_query_batch(3, coo.num_cols, seed=5)
    if shape == "empty_negative":
        queries = np.abs(queries)
    refs = [sell_scores_np(eng.sell, q) for q in queries]

    if path == "single":
        for q, ref in zip(queries, refs):
            _check_topk(*eng.query(q), ref, K)
    elif path == "batch":
        bi, bv = eng.query_batch(queries, group_size=2)  # padded tail group
        assert bi.shape == (3, K)
        for i, ref in enumerate(refs):
            _check_topk(bi[i], bv[i], ref, K)
    elif path == "scores":
        for q, ref in zip(queries, refs):
            s = eng.scores(q)
            assert np.all(np.isfinite(s))
            np.testing.assert_allclose(s, ref, atol=1e-5)
    elif path == "sharded":
        sharded = ShardedBucketedTopKSpMV(coo, cfg, mesh=make_mesh())
        assert sharded.mesh.devices.size == 8
        _check_topk(*sharded.query(queries[0]), refs[0], K)
        bi, bv = sharded.query_batch(queries, group_size=2)
        for i, ref in enumerate(refs):
            _check_topk(bi[i], bv[i], ref, K)
    else:
        p = str(tmp_path / "eng.npz")
        eng.save(p)
        loaded = TopKSpMV.load(p)
        assert loaded.config == eng.config
        for q in queries[:2]:
            i1, v1 = map(np.asarray, eng.query(q))
            i2, v2 = map(np.asarray, loaded.query(q))
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(loaded.scores(queries[0]),
                                      eng.scores(queries[0]))


@pytest.mark.parametrize("codec", ["f32", "h16"])
def test_out_of_range_column_stays_finite(codec):
    """A word whose column lies past the query (it carries a zero value, as
    padding words do) must add 0, not NaN: the gather clamps."""
    col = 300 if codec == "f32" else 1000
    if codec == "f32":
        word = col << 16                       # value bits 0
    else:
        word = col | (col << 16)               # both halves: val6 = 0
    words = np.zeros((1, 2, LANES), np.int32)
    words[0, 1, 5] = word
    x = jnp.ones(128, jnp.float32)
    s = np.asarray(bucket_scores(jnp.asarray(words), x, codec))
    assert np.all(np.isfinite(s)) and np.all(s == 0.0)
    sb = np.asarray(bucket_scores(jnp.asarray(words), jnp.ones((128, 3)),
                                  codec))
    assert sb.shape == (1, LANES, 3) and np.all(sb == 0.0)


def test_lane_topk_first_of_ties_and_masking():
    """Tied scores keep the lowest slice index first (the reference's
    argmin-replacement order); masked lanes score -inf."""
    scores = jnp.zeros((6, LANES), jnp.float32).at[4, 0].set(1.0)
    valid = jnp.ones((6, LANES), bool).at[0, 1].set(False)
    v, t = map(np.asarray, lane_topk(scores, valid, 3))
    assert v.shape == t.shape == (3, LANES)
    np.testing.assert_array_equal(t[:, 0], [4, 0, 1])
    np.testing.assert_array_equal(t[:, 2], [0, 1, 2])
    np.testing.assert_array_equal(t[:, 1], [1, 2, 3])
    # the batched form: (S, 128, Q) scores -> (Q, K, 128)
    vb, tb = map(np.asarray, lane_topk(
        jnp.stack([scores, -scores], axis=-1), valid, 2))
    assert vb.shape == (2, 2, LANES)
    np.testing.assert_array_equal(tb[0, :, 0], [4, 0])
    np.testing.assert_array_equal(tb[1, :, 0], [0, 1])


def test_tied_scores_return_distinct_rows():
    """Pattern-style data (all values equal) produces heavy score ties;
    the per-lane Top-K keeps distinct tied rows and the exact value."""
    rng = np.random.default_rng(110)
    n, c, d = 2000, 256, 6
    rows = np.repeat(np.arange(n, dtype=np.int32), d)
    cols = np.concatenate(
        [rng.choice(c, d, replace=False) for _ in range(n)]).astype(np.int32)
    vals = np.ones(n * d, np.float32)
    coo = CooMatrix(rows, cols, vals, n, c).sort_row_major()
    q = np.ones(c, np.float32)                  # score = d for EVERY row
    eng = TopKSpMV(coo, TopKSpMVConfig(k=64, max_cols=256))
    idx, vals_out = map(np.asarray, eng.query(q))
    assert len(set(idx.tolist())) == 64
    np.testing.assert_allclose(vals_out, d, atol=1e-5)


def test_lane_k_approximation_recall():
    """Per-lane K smaller than the number of slices per lane makes results
    approximate, the analog of per-partition K=8 (types.hpp:51) — recall
    should still be high, as modeled by topk_errors.py."""
    coo = create_sparse_matrix(4000, 256, 10, "uniform", seed=14)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=100, lane_k=8, max_cols=256))
    assert eng.sell.num_slices > 8
    q = create_sample_vector(256, seed=15)
    ki, _ = map(np.asarray, eng.query(q, k=100))
    gi, _ = topk_exact(coo, q, 100)
    assert _precision(gi, ki) >= 0.97


@pytest.mark.parametrize("quantum", [1, 2, 4, 8])
@pytest.mark.parametrize("codec", ["f32", "h16"])
def test_width_quantum_engines_match_reference(codec, quantum):
    """Every width ladder packs and sweeps to the same Top-K as the
    reference over its own packed words."""
    coo = create_sparse_matrix(3000, 512, 17, "uniform", seed=93)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=50, lane_k=24, max_cols=512,
                                       query_codec=codec,
                                       width_quantum=quantum))
    if quantum == 1:
        assert any(b.width % 2 == 1 for b in eng.sell.buckets)
    q = create_sample_vector(512, seed=94)
    _check_topk(*eng.query(q), sell_scores_np(eng.sell, q), 50)


def test_width_quantum2_reduces_padding():
    # low-degree corpus: the quantum matters most at small slice widths
    coo = create_sparse_matrix(60000, 512, 9, "gamma", seed=85)
    pads = {quantum: pack_sell_buckets(coo, TopKSpMVConfig(
        max_cols=512, width_quantum=quantum)).padding_ratio
        for quantum in (4, 2)}
    assert pads[2] < pads[4]


def test_width_quantum4_reduces_padding():
    coo = create_sparse_matrix(60000, 512, 20, "gamma", seed=85)
    pads = {quantum: pack_sell_buckets(coo, TopKSpMVConfig(
        max_cols=512, width_quantum=quantum)).padding_ratio
        for quantum in (8, 4)}
    assert pads[4] < pads[8]


def test_width_quantum1_padding_below_quantum2():
    coo = create_sparse_matrix(30000, 512, 20, "gamma", seed=103)
    width_sums = {}
    for quantum in (2, 1):
        m = pack_sell_buckets(coo, TopKSpMVConfig(
            max_cols=512, query_codec="h16", width_quantum=quantum))
        width_sums[quantum] = sum(b.width * b.num_slices for b in m.buckets)
    assert width_sums[1] < width_sums[2]


def test_unsorted_duplicate_width_buckets():
    """With sigma_sort=False quantized widths are non-monotone, so several
    buckets share a width; each keeps its own words and slice range."""
    coo = create_sparse_matrix(3000, 512, 14, "gamma", seed=140)
    cfg = TopKSpMVConfig(k=40, lane_k=24, max_cols=512, sigma_sort=False)
    eng = TopKSpMV(coo, cfg)
    widths = [b.width for b in eng.sell.buckets]
    assert len(set(widths)) < len(widths), (
        "fixture must produce duplicate-width buckets")
    q = create_sample_vector(512, seed=141)
    _check_topk(*eng.query(q), sell_scores_np(eng.sell, q), 40)


def test_save_load_without_npz_suffix(tmp_path):
    """save('eng.bin') then load('eng.bin') must work (np.savez appends
    '.npz' to bare-string paths)."""
    coo = create_sparse_matrix(2000, 512, 10, "uniform", seed=143)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=20, max_cols=512))
    p = str(tmp_path / "eng.bin")
    eng.save(p)
    eng2 = TopKSpMV.load(p)
    q = create_sample_vector(512, seed=144)
    i1, _ = map(np.asarray, eng.query(q))
    i2, _ = map(np.asarray, eng2.query(q))
    np.testing.assert_array_equal(i1, i2)


def test_query_rejects_wrong_shapes():
    coo = create_sparse_matrix(600, 256, 10, "uniform", seed=18)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=10, max_cols=256))
    with pytest.raises(ValueError, match="shape"):
        eng.query(np.ones(255, np.float32))
    with pytest.raises(ValueError, match="shape"):
        eng.query_batch(np.ones((2, 255), np.float32))


def test_segment_xla_baseline():
    coo = create_sparse_matrix(900, 256, 10, "uniform", seed=16)
    q = create_sample_vector(256, seed=17)
    i, v = topk_spmv_segment_xla(coo.rows, coo.cols, coo.vals, q,
                                 coo.num_rows, 20)
    gi, gv = topk_exact(coo, q, 20)
    assert _precision(gi, np.asarray(i)) == 1.0


@pytest.mark.parametrize("field", [
    "interpret", "fused_layout", "num_partitions", "fold_tile",
    "chunk_sublanes", "block_sublanes", "fused_block_sublanes",
    "batch_subgroup", "tie_safe_topk", "layout", "slice_height"])
def test_config_has_no_device_geometry_knobs(field):
    """The sweep sets its own shapes: the old per-device geometry and
    tuning fields are not part of the configuration."""
    with pytest.raises(TypeError):
        TopKSpMVConfig(**{field: 1})


@pytest.mark.parametrize("codec,max_cols,ok", [
    ("f32", 65536, True), ("f32", 65664, False), ("h16", 1024, True),
    ("h16", 1152, False), ("i4s", 1024, False), ("int8x4", 1024, False)])
def test_config_codec_and_column_limits(codec, max_cols, ok):
    if ok:
        assert TopKSpMVConfig(query_codec=codec, max_cols=max_cols)
    else:
        with pytest.raises(ValueError):
            TopKSpMVConfig(query_codec=codec, max_cols=max_cols)
