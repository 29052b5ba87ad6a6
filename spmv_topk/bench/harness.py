"""Benchmark harness with the reference's CSV protocol.

Reproduces the per-iteration benchmark loop of the reference hosts
(host_spmv_bscsr.cpp:602-706): for each iteration draw a fresh random
L2-normalized query, run the exact software gold and the device engine,
compare (error counts, precision), and emit one CSV row with the
reference's column layout (host_spmv_bscsr.cpp:666-691):

  iteration,error_idx,error_val,sw_full_time_ms,sw_topk_time_ms,
  hw_setup_time_ms,hw_exec_time_ms,hw_full_exec_time_ms,readback_time_ms,
  k,sw_res_idx,sw_res_val,hw_res_idx,hw_res_val

plus appended quality columns (precision, ndcg, kendall_tau) that the
reference computes offline in plot_errors.py. Summaries use the
warm-up-skipped mean±std (evaluation_utils.hpp:274-297).
"""

from __future__ import annotations

import dataclasses
import io
import time
from typing import Optional

import numpy as np

from ..eval import metrics
from ..formats.coo import CooMatrix
from ..formats.synthetic import create_sample_vector
from ..ops.gold import topk_exact

CSV_HEADER = (
    "iteration,error_idx,error_val,sw_full_time_ms,sw_topk_time_ms,"
    "hw_setup_time_ms,hw_exec_time_ms,hw_full_exec_time_ms,readback_time_ms,"
    "k,sw_res_idx,sw_res_val,hw_res_idx,hw_res_val,"
    "precision,ndcg,kendall_tau"
)


@dataclasses.dataclass
class BenchResult:
    rows: list
    csv: str
    mean_exec_ms: float
    std_exec_ms: float
    mean_precision: float
    nnz_per_sec: float


def run_benchmark(
    engine,
    coo: CooMatrix,
    num_tests: int = 30,
    k: Optional[int] = None,
    seed: int = 0,
    warmup_skip: int = 2,
    debug: bool = False,
) -> BenchResult:
    """Run the reference's randomized-query benchmark loop against `engine`
    (TopKSpMV or ShardedTopKSpMV)."""
    k = k or engine.config.k
    out = io.StringIO()
    out.write(CSV_HEADER + "\n")
    rows = []
    exec_times = []

    # warm the compiled kernel once (hw_setup analog; the reference counts
    # xclbin load + buffer migration here, host_spmv_bscsr.cpp:583-597)
    t0 = time.perf_counter()
    warm_q = create_sample_vector(coo.num_cols, seed=seed + 10_000)
    np.asarray(engine.query(warm_q)[0])
    setup_ms = (time.perf_counter() - t0) * 1e3

    for it in range(num_tests):
        q = create_sample_vector(coo.num_cols, seed=seed + it)

        t0 = time.perf_counter()
        sw_idx, sw_val = topk_exact(coo, q, k)
        sw_full_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        hw_idx, hw_val = engine.query(q, k)
        t_disp = time.perf_counter()
        hw_idx = np.asarray(hw_idx)[:k]
        hw_val = np.asarray(hw_val)[:k]
        t1 = time.perf_counter()
        hw_exec_ms = (t1 - t0) * 1e3
        readback_ms = (t1 - t_disp) * 1e3

        error_idx = metrics.count_positional_errors(sw_idx, hw_idx)
        # reference tolerance regime: idx exact, values ~1e-5 abs
        # (host_spmv_bscsr.cpp check_array_equality); quantized codecs
        # legitimately report non-zero error_val here — that is the metric.
        error_val = int(np.sum(~np.isclose(
            np.sort(sw_val), np.sort(hw_val), atol=1e-5, rtol=1e-4)))
        precision = metrics.precision_at_k(sw_idx, hw_idx)
        ndcg = metrics.ndcg(sw_idx, hw_idx)
        tau = metrics.kendall_tau(sw_idx, hw_idx)

        row = dict(
            iteration=it, error_idx=error_idx, error_val=error_val,
            sw_full_time_ms=sw_full_ms, sw_topk_time_ms=sw_full_ms,
            hw_setup_time_ms=setup_ms, hw_exec_time_ms=hw_exec_ms,
            hw_full_exec_time_ms=hw_exec_ms, readback_time_ms=readback_ms,
            k=k, precision=precision, ndcg=ndcg, kendall_tau=tau,
        )
        rows.append(row)
        exec_times.append(hw_exec_ms)
        out.write(
            f"{it},{error_idx},{error_val},{sw_full_ms:.3f},{sw_full_ms:.3f},"
            f"{setup_ms:.3f},{hw_exec_ms:.3f},{hw_exec_ms:.3f},"
            f"{readback_ms:.3f},{k},"
            f"\"{';'.join(map(str, sw_idx[:10]))}\","
            f"\"{';'.join(f'{v:.5f}' for v in sw_val[:10])}\","
            f"\"{';'.join(map(str, hw_idx[:10]))}\","
            f"\"{';'.join(f'{v:.5f}' for v in hw_val[:10])}\","
            f"{precision:.4f},{ndcg:.4f},{tau:.4f}\n"
        )
        if debug:
            print(f"iter {it}: exec {hw_exec_ms:.2f} ms, precision {precision:.3f}")

    mean_ms = metrics.mean(exec_times, skip=warmup_skip)
    return BenchResult(
        rows=rows,
        csv=out.getvalue(),
        mean_exec_ms=mean_ms,
        std_exec_ms=metrics.st_dev(exec_times, skip=warmup_skip),
        mean_precision=float(np.mean([r["precision"] for r in rows])),
        nnz_per_sec=coo.nnz / (mean_ms / 1e3) if mean_ms == mean_ms else float("nan"),
    )


def device_step_seconds(engine, group: int = 0, seed: int = 7) -> float:
    """Seconds per device step of a TopKSpMV engine — sweep and merge to
    max(k, rescore_pool) candidates, no host rescore — for one query
    (group=0) or one (C, group) query group, from the slope between a
    short and a long lax.scan over distinct queries (dispatch cancels).
    The engine arrays are jit arguments, never baked-in constants."""
    import jax
    import jax.numpy as jnp

    from ..formats.synthetic import create_query_batch
    from ..ops.sweep import topk_query
    from ..utils.profiling import timed_slope

    cfg = engine.config
    k = max(cfg.k, cfg.rescore_pool or 0)
    n_max = 24 if group else 64
    C = engine.num_cols
    qs = create_query_batch(n_max * max(group, 1), C, seed=seed)
    xs = qs.reshape(n_max, group, C).transpose(0, 2, 1) if group else qs
    xs = jax.device_put(jnp.asarray(xs), engine.device)

    @jax.jit
    def run(words, valid, row_ids, xs):
        def step(c, x):
            _, v = topk_query(words, valid, row_ids, x,
                              codec=cfg.query_codec, lane_k=cfg.lane_k, k=k)
            return c + v[..., 0].sum(), None
        return jax.lax.scan(step, 0.0, xs)[0]

    def run_n(n):
        np.asarray(run(engine._words, engine._valid, engine._row_ids,
                       xs[:n]))

    return timed_slope(run_n, n_max // 8, n_max)

