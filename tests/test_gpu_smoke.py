"""On-card smoke tests (`-m gpu`): the compiled sweep on an NVIDIA GPU.

The CPU suite runs the same plain-JAX code through XLA:CPU; these tests
compile it for the card, where gathers, reductions and lax.top_k take
GPU-specific code paths, and compare with the same references on small
corpora. They skip unless JAX runs on a GPU; `python chip_smoke.py` runs
them on the card (or: JAX_PLATFORMS=cuda python -m pytest tests -m gpu).

The differential protocol matches the reference hosts: exact gold top-k
on the same matrix+query, index-set precision + value tolerance
(host_spmv_bscsr.cpp:638-663).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_topk.api import TopKSpMV
from spmv_topk.config import LANES, TopKSpMVConfig
from spmv_topk.formats import (create_query_batch, create_sample_vector,
                               create_sparse_matrix)
from spmv_topk.ops.gold import topk_exact
from spmv_topk.ops.xla_ref import sell_scores_np

pytestmark = pytest.mark.gpu


def _precision(a, b):
    return len(set(np.asarray(a).tolist())
               & set(np.asarray(b).tolist())) / len(a)


@pytest.fixture(scope="module")
def small():
    coo = create_sparse_matrix(20_000, 1024, 20, "gamma", seed=70)
    q = create_sample_vector(1024, seed=71)
    gi, gv = topk_exact(coo, q, 100)
    return coo, q, gi, gv


def test_h16_rescore_matches_gold(gpu, small):
    """The production configuration: exact after the host rescore."""
    coo, q, gi, gv = small
    eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="h16",
                                       width_quantum=2, rescore_pool=400))
    ki, kv = map(np.asarray, eng.query(q))
    assert _precision(gi, ki) == 1.0
    np.testing.assert_allclose(np.sort(kv), np.sort(gv), atol=1e-5)


@pytest.mark.parametrize("codec", ["f32", "h16"])
def test_scores_and_topk_match_reference(gpu, small, codec):
    coo, q, _, _ = small
    eng = TopKSpMV(coo, TopKSpMVConfig(k=100, lane_k=160,
                                       query_codec=codec))
    ref = sell_scores_np(eng.sell, q)
    np.testing.assert_allclose(eng.scores(q), ref, atol=1e-5)
    ki, kv = map(np.asarray, eng.query(q))
    np.testing.assert_allclose(kv, ref[ki], atol=1e-5)
    np.testing.assert_allclose(kv, np.sort(ref)[::-1][:100], atol=1e-5)


def test_query_batch_matches_single(gpu, small):
    coo, _, _, _ = small
    eng = TopKSpMV(coo, TopKSpMVConfig(k=100, query_codec="h16",
                                       width_quantum=2))
    qs = create_query_batch(5, 1024, seed=80)
    bi, bv = map(np.asarray, eng.query_batch(qs, group_size=4))
    for i in range(5):
        si, sv = map(np.asarray, eng.query(qs[i]))
        assert _precision(si, bi[i]) == 1.0
        np.testing.assert_allclose(np.sort(bv[i]), np.sort(sv), atol=1e-5)


def test_save_load_roundtrip(gpu, small, tmp_path):
    coo, q, _, _ = small
    eng = TopKSpMV(coo, TopKSpMVConfig(k=100))
    p = str(tmp_path / "eng.npz")
    eng.save(p)
    eng2 = TopKSpMV.load(p)
    i1, v1 = map(np.asarray, eng.query(q))
    i2, v2 = map(np.asarray, eng2.query(q))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)


def test_sharded_engine_on_one_card(gpu, small):
    from spmv_topk.parallel import ShardedBucketedTopKSpMV, make_mesh

    coo, q, gi, gv = small
    cfg = TopKSpMVConfig(k=100, query_codec="h16", rescore_pool=400)
    eng = ShardedBucketedTopKSpMV(coo, cfg, mesh=make_mesh([gpu]))
    ki, kv = map(np.asarray, eng.query(q))
    assert _precision(gi, ki) == 1.0
    np.testing.assert_allclose(np.sort(kv), np.sort(gv), atol=1e-5)


@pytest.mark.parametrize("codec", ["f32", "h16"])
def test_out_of_range_column_stays_finite(gpu, codec):
    from spmv_topk.ops.sweep import bucket_scores

    col = 300 if codec == "f32" else 1000
    words = np.zeros((1, 2, LANES), np.int32)
    words[0, 1, 5] = (col << 16) if codec == "f32" else col | (col << 16)
    s = np.asarray(jax.jit(bucket_scores, static_argnums=2)(
        jnp.asarray(words), jnp.ones(128, jnp.float32), codec))
    assert np.all(s == 0.0)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_dense_engine(gpu, small, dtype):
    from spmv_topk.ops.dense import DenseTopKSpMV

    coo, q, gi, _ = small
    deng = DenseTopKSpMV(coo, TopKSpMVConfig(k=100), dtype=dtype)
    idx, _ = map(np.asarray, deng.query_batch(q[None]))
    assert _precision(gi, idx[0]) >= 0.95
