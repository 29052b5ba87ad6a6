"""Command-line benchmark entry point.

The analog of the reference hosts' CLI (`struct Options`,
/root/reference/src/common/utils/options.hpp:37-133) and their main
benchmark loop (host_spmv_bscsr.cpp:510-707):

  python -m spmv_topk -m data/matrix.mtx -k 100 -t 30
  python -m spmv_topk --synthetic 1000000 1024 20 gamma --codec h16

Flags follow the reference where meaningful: -m matrix, -k top-k
(default 20, options.hpp:28), -t num tests (default 3), -d debug prints,
-v ignore matrix values (pattern treatment). FPGA-only flags (xclbin,
block/grid size) are replaced by the engine's knobs (--codec,
--width-quantum, --lane-k, --rescore-pool).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spmv_topk")
    ap.add_argument("-m", "--matrix", help="MTX file path")
    ap.add_argument("--synthetic", nargs=4, metavar=("ROWS", "COLS", "DEG", "DIST"),
                    help="generate a synthetic matrix instead of -m")
    ap.add_argument("-k", type=int, default=20)
    ap.add_argument("-t", "--num-tests", type=int, default=3)
    ap.add_argument("-d", "--debug", action="store_true")
    ap.add_argument("-v", "--ignore-values", action="store_true",
                    help="treat the matrix as pattern (all values 1)")
    ap.add_argument("--codec", default="f32", choices=["f32", "h16"],
                    help="packed word format (h16 = 2 nnz per word with "
                         "6-bit values; pair with --rescore-pool)")
    ap.add_argument("--lane-k", type=int, default=8)
    ap.add_argument("--width-quantum", type=int, default=8,
                    choices=[1, 2, 4, 8],
                    help="slice-width granularity (finer = less padding)")
    ap.add_argument("--rescore-pool", type=int, default=None,
                    help="exact host CSR re-ranking of the top-N device "
                         "candidates (restores exact ranking for h16; "
                         "try 4-8x k)")
    ap.add_argument("--engine", default="sparse",
                    choices=["sparse", "dense"],
                    help="dense = bf16 matmul sweep + approx_max_k "
                         "(batched serving; the dense form must fit in "
                         "device memory)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard across all visible devices")
    ap.add_argument("--csv", help="write the per-iteration CSV here")
    args = ap.parse_args(argv)

    from .utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    from .api import TopKSpMV
    from .bench.harness import run_benchmark
    from .config import TopKSpMVConfig
    from .formats import create_sparse_matrix, read_mtx

    if args.synthetic:
        rows, cols, deg, dist = args.synthetic
        coo = create_sparse_matrix(int(rows), int(cols), int(deg), dist, seed=1)
    elif args.matrix:
        coo = read_mtx(args.matrix, read_values=not args.ignore_values)
    else:
        ap.error("provide -m or --synthetic")

    cfg = TopKSpMVConfig(
        k=args.k, lane_k=args.lane_k,
        query_codec=args.codec,
        width_quantum=args.width_quantum,
        max_cols=max(128, -(-coo.num_cols // 128) * 128),
        rescore_pool=args.rescore_pool,
    )
    if args.engine == "dense":
        from .ops.dense import DenseTopKSpMV
        from .parallel.sharded_dense import ShardedDenseTopKSpMV

        engine = (ShardedDenseTopKSpMV(coo, cfg) if args.mesh
                  else DenseTopKSpMV(coo, cfg))
    elif args.mesh:
        from .parallel.sharded_buckets import ShardedBucketedTopKSpMV

        engine = ShardedBucketedTopKSpMV(coo, cfg)
    else:
        engine = TopKSpMV(coo, cfg)

    res = run_benchmark(engine, coo, num_tests=args.num_tests, k=args.k,
                        debug=args.debug)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(res.csv)
    print(
        f"exec {res.mean_exec_ms:.3f} +- {res.std_exec_ms:.3f} ms; "
        f"precision {res.mean_precision:.4f}; "
        f"{res.nnz_per_sec / 1e9:.2f} GNNZ/s over {coo.nnz} nnz"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
