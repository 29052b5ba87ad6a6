#!/usr/bin/env python
"""Headline benchmark: Top-K SpMV on one device.

Workload: synthetic 10M x 1024 gamma-sparsity embedding matrix (~195M
nnz, L2-normalized rows), K=100 with lane_k=8 — the SAME nnz scale as the
reference's 2x10^8-nnz single-card headline (plot_roofline.py:201-209).

Engine: the production configuration — h16 words (two nnz per 32-bit
word) at width_quantum=2, with exact host rescoring of the top-400 pool.

Timing protocol (bench.harness.device_step_seconds): the device step
(sweep + global merge) is iterated over a stream of distinct queries
inside one jitted lax.scan; the per-query time is the slope between a
short and a long stream, so dispatch overhead cancels. The host rescore
is timed separately and added for the end-to-end figure.

Prints one JSON line per section (single query, batch of 32, dense); each
line is a superset of the previous one and names the device it ran on.
The run fails when JAX finds no accelerator: a CPU number is never
reported under a device metric.

Cold-start costs are cached on disk: the corpus in .bench_cache/*.npz and
the packed engine via TopKSpMV.save()/load().
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from spmv_topk.utils.profiling import enable_compilation_cache

enable_compilation_cache()

from spmv_topk.api import TopKSpMV
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix, create_query_batch
from spmv_topk.formats.coo import CooMatrix
from spmv_topk.bench import device_step_seconds

# headline corpus (the reference benchmark shape at 10x the rows);
# override for smoke runs: SPMV_BENCH_ROWS=300000 python bench.py
NUM_ROWS = int(os.environ.get("SPMV_BENCH_ROWS", 10_000_000))
NUM_COLS = int(os.environ.get("SPMV_BENCH_COLS", 1024))
AVG_DEG = 20
K = 100
CACHE_DIR = os.environ.get("SPMV_BENCH_CACHE",
                           os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), ".bench_cache"))


def _corpus() -> tuple[CooMatrix, float, bool]:
    """Headline corpus, disk-cached: (coo, seconds, was_cached)."""
    key = f"corpus_{NUM_ROWS}_{NUM_COLS}_{AVG_DEG}_gamma_s1.npz"
    path = os.path.join(CACHE_DIR, key)
    t0 = time.time()
    if os.path.exists(path):
        z = np.load(path)
        coo = CooMatrix(z["rows"], z["cols"], z["vals"],
                        int(z["dims"][0]), int(z["dims"][1]))
        coo._sorted = True  # generated row-major; invariant of the cache
        return coo, time.time() - t0, True
    coo = create_sparse_matrix(NUM_ROWS, NUM_COLS, AVG_DEG, "gamma", seed=1)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # uncompressed: load speed is the point
        np.savez(fh, rows=coo.rows, cols=coo.cols, vals=coo.vals,
                 dims=np.array([coo.num_rows, coo.num_cols], np.int64))
    os.replace(tmp, path)
    return coo, time.time() - t0, False


def _engine(coo: CooMatrix, cfg: TopKSpMVConfig):
    """Packed engine, disk-cached via save()/load: (eng, secs, cached)."""
    tag = (f"eng_{NUM_ROWS}_{NUM_COLS}_{AVG_DEG}_q{cfg.width_quantum}"
           f"_{cfg.query_codec}_r{cfg.rescore_pool}_v5.npz")
    path = os.path.join(CACHE_DIR, tag)
    t0 = time.time()
    if os.path.exists(path):
        try:
            eng = TopKSpMV.load(path, matrix=coo)
            return eng, time.time() - t0, True
        except (OSError, KeyError, ValueError) as e:  # stale snapshot
            print(f"engine snapshot reload failed ({e!r}); repacking",
                  file=sys.stderr)
    eng = TopKSpMV(coo, cfg)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + ".tmp"
    eng.save(tmp)
    os.replace(tmp, path)
    return eng, time.time() - t0, False


def _timed(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def main():
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench.py measures an accelerator; JAX found only "
                         "the CPU")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    coo, gen_s, corpus_cached = _corpus()
    cfg = TopKSpMVConfig(k=K, lane_k=8, max_cols=NUM_COLS,
                         query_codec="h16", width_quantum=2,
                         rescore_pool=400)
    eng, pack_s, eng_cached = _engine(coo, cfg)
    pool = cfg.rescore_pool

    t0 = time.time()
    per_query = device_step_seconds(eng)
    setup_and_compile_s = time.time() - t0

    q = create_query_batch(1, NUM_COLS, seed=3)[0]
    gold = eng._scipy_csr @ q
    gpart = np.argpartition(-gold, K - 1)[:K]
    gi = gpart[np.argsort(-gold[gpart], kind="stable")]
    ki = np.asarray(eng.query(q)[0])
    raw_i = np.asarray(eng.query(q, rescore_pool=0)[0])
    pool_i = np.asarray(eng.query(q, k=pool, rescore_pool=0)[0])
    rescore_ms = min(_timed(lambda: eng._rescore(pool_i, q, K))
                     for _ in range(10)) * 1e3

    result = {
        "metric": "topk_spmv_single_query_ms",
        "per_query_ms": per_query * 1e3,
        "per_query_e2e_ms": per_query * 1e3 + rescore_ms,
        "rescore_host_ms": rescore_ms,
        "gnnz_per_s": coo.nnz / per_query / 1e9,
        "stream_gbps": eng.hbm_bytes / per_query / 1e9,
        "bytes_per_nnz": eng.bytes_per_nnz,
        "precision_at_100": len(set(gi.tolist()) & set(ki.tolist())) / K,
        "precision_raw_h16": len(set(gi.tolist()) & set(raw_i.tolist())) / K,
        "nnz": coo.nnz,
        "corpus_seconds": gen_s, "corpus_cached": corpus_cached,
        "pack_seconds": pack_s, "engine_cached": eng_cached,
        "timing_seconds_incl_compile": setup_and_compile_s,
        "device": device,
    }
    print(json.dumps(result), flush=True)

    # batch of 32: the sweep reads each word once per group
    QB = 32
    per_group = device_step_seconds(eng, QB)
    result.update({
        "batch32_ms_per_query": per_group * 1e3 / QB,
        "batch32_gnnz_per_query": coo.nnz / (per_group / QB) / 1e9,
    })
    print(json.dumps(result), flush=True)

    # dense engine (bf16 matmul sweep + approx_max_k) when it fits
    from spmv_topk.ops.dense import DenseTopKSpMV

    try:
        deng = DenseTopKSpMV(coo, TopKSpMVConfig(k=K, max_cols=NUM_COLS))
    except ValueError as e:  # the dense form does not fit on the device
        print(f"dense section skipped: {e}", file=sys.stderr)
        return
    QD = 64
    qd = create_query_batch(QD, NUM_COLS, seed=5)
    t_d = min(_timed(lambda: np.asarray(deng.query_batch(qd)[1]))
              for _ in range(4))
    di = np.asarray(deng.query_batch(q[None])[0])[0]
    result.update({
        "dense_batch64_ms_per_query": t_d * 1e3 / QD,
        "dense_precision_at_100": len(set(gi.tolist())
                                      & set(di.tolist())) / K,
    })
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
