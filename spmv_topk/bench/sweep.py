"""Benchmark sweep driver.

Port of the reference's sweep (test_spmv_topk.py:15-108): a grid of
{rows} x {cols} x {degree distribution} x {nnz/row} synthetic matrices,
K=100, 30 iterations each, one CSV per configuration named with the
reference's convention
  {impl}_{rows}_{cols}_{dist}_{nnz}_{bits}_{partitions}_{k}_{iters}.csv
(cf. plot_errors.py:52). Run as:

  python -m spmv_topk.bench.sweep --rows 1000000 --out results/
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np

from ..api import TopKSpMV
from ..config import BF16, TopKSpMVConfig
from ..formats.synthetic import create_sparse_matrix
from .harness import run_benchmark

DEFAULT_ROWS = [100_000]
DEFAULT_COLS = [512, 1024]
DEFAULT_DIST = ["uniform", "gamma"]
DEFAULT_DEG = [20, 40]


def run_sweep(rows_list, cols_list, dist_list, deg_list, k, num_tests,
              out_dir, codec="f32", rescore_pool=None):
    os.makedirs(out_dir, exist_ok=True)
    summary = []
    for rows, cols, dist, deg in itertools.product(
        rows_list, cols_list, dist_list, deg_list
    ):
        name = (f"jax-{codec}_{rows}_{cols}_{dist}_{deg}_bf16_1_{k}"
                f"_{num_tests}")
        t0 = time.time()
        coo = create_sparse_matrix(rows, cols, deg, dist, seed=1)
        cfg = TopKSpMVConfig(k=k, value_format=BF16,
                             max_cols=max(cols, 128), query_codec=codec,
                             width_quantum=4 if codec != "f32" else 8,
                             rescore_pool=rescore_pool)
        eng = TopKSpMV(coo, cfg)
        res = run_benchmark(eng, coo, num_tests=num_tests, k=k, seed=2)
        path = os.path.join(out_dir, name + ".csv")
        with open(path, "w") as f:
            f.write(res.csv)
        row = dict(
            config=name, nnz=coo.nnz,
            mean_exec_ms=round(res.mean_exec_ms, 3),
            std_exec_ms=round(res.std_exec_ms, 3),
            gnnz_per_sec=round(res.nnz_per_sec / 1e9, 2),
            precision=round(res.mean_precision, 4),
            wall_s=round(time.time() - t0, 1),
        )
        summary.append(row)
        print(json.dumps(row))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=DEFAULT_ROWS)
    ap.add_argument("--cols", type=int, nargs="+", default=DEFAULT_COLS)
    ap.add_argument("--dist", nargs="+", default=DEFAULT_DIST)
    ap.add_argument("--deg", type=int, nargs="+", default=DEFAULT_DEG)
    ap.add_argument("-k", type=int, default=100)
    ap.add_argument("-t", "--num-tests", type=int, default=30)
    ap.add_argument("--out", default="results")
    ap.add_argument("--codec", default="f32", choices=["f32", "h16"])
    ap.add_argument("--rescore-pool", type=int, default=None)
    args = ap.parse_args()
    run_sweep(args.rows, args.cols, args.dist, args.deg, args.k,
              args.num_tests, args.out, codec=args.codec,
              rescore_pool=args.rescore_pool)


if __name__ == "__main__":
    main()
