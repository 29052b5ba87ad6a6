"""Quickstart: build an engine from a synthetic corpus and query it."""

import os
import sys
import tempfile

import numpy as np

# editable-install fallback: lets the example run from a plain git
# checkout; `pip install -e .` (pyproject.toml) makes this a no-op
if __package__ is None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import spmv_topk as st
from spmv_topk.formats import create_sparse_matrix, create_sample_vector

# 1M sparse embeddings, 1024 dims, ~20 nnz each (gamma-skewed degrees)
corpus = create_sparse_matrix(1_000_000, 1024, 20, "gamma", seed=0)

# Build once: packs to the bucketed SELL layout and leaves the matrix
# resident in device memory.
engine = st.TopKSpMV(corpus, st.TopKSpMVConfig(k=100))

# Query many times (the reference's reset() loop, for free).
for i in range(3):
    q = create_sample_vector(1024, seed=i)
    idx, vals = engine.query(q)
    print(f"query {i}: top-5 rows {np.asarray(idx)[:5]} "
          f"scores {np.asarray(vals)[:5].round(4)}")

# Batched queries amortize the matrix stream (SpMM path).
batch = np.stack([create_sample_vector(1024, seed=10 + i) for i in range(16)])
idx, vals = engine.query_batch(batch)
print("batch:", np.asarray(idx).shape)

# Production mode: the h16 codec packs 2 nnz per word (half the bytes
# streamed per query); the rescore pool re-ranks the top-400 candidates
# with exact f32 dot products on the host CSR, so the served top-k is
# exact in practice.
fast = st.TopKSpMV(corpus, st.TopKSpMVConfig(
    k=100, query_codec="h16", width_quantum=2, rescore_pool=400))
print("fast top-5:", np.asarray(fast.query(create_sample_vector(1024, seed=0))[0])[:5])

# Persist the packed engine: serving restarts skip the re-pack. (A
# load()ed engine has no host CSR, so query it with rescore_pool=0 or
# pass matrix= to load() to rescore.)
snapshot = os.path.join(tempfile.mkdtemp(), "corpus_packed.npz")
fast.save(snapshot)
reloaded = st.TopKSpMV.load(snapshot)
print("reloaded top-5:",
      np.asarray(reloaded.query(create_sample_vector(1024, seed=0),
                                rescore_pool=0)[0])[:5])

# Batched serving from the dense form when it fits in device memory
# (~2 GB here): bf16 matmul sweep + approx_max_k.
dense = st.DenseTopKSpMV(corpus, st.TopKSpMVConfig(k=100))
idx, vals = dense.query_batch(batch)
print("dense batch:", np.asarray(idx).shape)
