"""One-command MTX search: parse -> pack -> serve -> accuracy.

  python examples/mtx_search.py matrix.mtx [k] [--f32]
  python examples/mtx_search.py --synthetic-glove [k]

The end-to-end flow of the reference benchmark hosts (readMtx ->
create_sample_vector -> SpMV -> gold check, host_spmv_bscsr.cpp:510-707)
as a library user would run it:

  1. parse the MTX file (native C++ parser when built, formats/mtx.py),
  2. build the matrix-resident engine (h16 words + exact host rescore of
     the top-400 pool; --f32 for one nnz per word without rescore),
  3. serve queries,
  4. report precision/NDCG against the exact CPU gold per query.

--synthetic-glove generates a GloVe-shaped corpus (2.2M x 300, ~25 nnz
per row — test_spmv_topk.py:28-32's real dataset geometry) when no real
MTX file is at hand.
"""

import os
import sys
import time

import numpy as np

# editable-install fallback: lets the example run from a plain git
# checkout; `pip install -e .` (pyproject.toml) makes this a no-op
if __package__ is None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spmv_topk.utils.profiling import enable_compilation_cache

enable_compilation_cache()

import spmv_topk as st
from spmv_topk.eval.metrics import ndcg, precision_at_k
from spmv_topk.formats import (create_query_batch, create_sparse_matrix,
                             read_mtx)
from spmv_topk.ops.gold import topk_exact


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    flags = {a for a in argv if a.startswith("--")}
    k = int(args[1]) if len(args) > 1 else 100

    t0 = time.time()
    if "--synthetic-glove" in flags:
        print("generating a GloVe-shaped corpus (2.2M x 300, deg 25)...")
        corpus = create_sparse_matrix(2_200_000, 300, 25, "gamma", seed=7)
        name = "synthetic-glove"
    else:
        if len(args) < 1 or not args or not os.path.exists(args[0]):
            print(__doc__)
            return 2
        name = args[0]
        corpus = read_mtx(name)
    parse_s = time.time() - t0
    print(f"{name}: {corpus.num_rows} x {corpus.num_cols}, "
          f"{corpus.nnz} nnz ({parse_s:.1f} s)")

    if "--f32" in flags:
        cfg = st.TopKSpMVConfig(k=k)
    else:
        cfg = st.TopKSpMVConfig(k=k, query_codec="h16", width_quantum=2,
                                rescore_pool=4 * k)
    print(f"config: codec={cfg.query_codec} quantum={cfg.width_quantum} "
          f"rescore_pool={cfg.rescore_pool}")

    t0 = time.time()
    engine = st.TopKSpMV(corpus, cfg)
    print(f"packed in {time.time() - t0:.1f} s "
          f"({engine.bytes_per_nnz:.2f} B/nnz on device)")

    queries = create_query_batch(5, corpus.num_cols, seed=0)
    times, precs, ndcgs = [], [], []
    for i, q in enumerate(queries):
        t0 = time.time()
        idx, vals = map(np.asarray, engine.query(q))
        times.append(time.time() - t0)
        gi, gv = topk_exact(corpus, q, k)
        precs.append(precision_at_k(gi, idx))
        ndcgs.append(ndcg(gi, idx))
        if i == 0:
            for r, v in list(zip(idx, vals))[:5]:
                print(f"  row {r:10d}  score {v:.6f}")
    # first query includes compile; steady state is the rest
    print(f"query wall: first {times[0] * 1e3:.1f} ms (incl. compile), "
          f"then {np.mean(times[1:]) * 1e3:.2f} ms mean "
          f"(host round-trip incl. dispatch; see bench.py for the "
          "slope-timed device time)")
    print(f"precision@{k} vs exact gold: {np.mean(precs):.4f}   "
          f"NDCG: {np.mean(ndcgs):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
