#!/usr/bin/env python
"""Smoke run of the Top-K SpMV engines on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded engines only

Phases (one card):
  main     the bench.py headline corpus (10M x 1024, average degree 20,
           gamma, seed 1) through TopKSpMV in the production configuration
           (h16 words, k=100, lane_k=8, rescore_pool=400, width_quantum=2):
           8 queries through query() and one group of 32 through
           query_batch(), each compared with the exact gold; then the f32
           configuration without rescore, whose device scores are compared
           with the NumPy reference over the same packed words.
  measure  device time of the single-query and batch-32 sweeps, each with
           its share of the card's memory roofline (bytes counted from the
           packed stream's shapes), beside what a plain copy reaches in
           the same process.
  dense    DenseTopKSpMV (bf16 and int8) on a 1M x 1024 corpus against the
           gold, with approx_max_k's share of the dense step.
  tests    the `gpu`-marked tests, run by pytest in this process.

--multi row-shards the headline corpus over four cards with
ShardedBucketedTopKSpMV and ShardedDenseTopKSpMV and compares both with
the single-device engines and the gold; no other phase runs.

The script drives the card from this one process; its only child is
nvidia-smi. It exits non-zero, and prints no result line, when JAX finds
no GPU or any phase fails. The last line of a successful run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
--rows cuts the corpus (never its width) for quick runs; the cut is
printed. A full log goes to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HEADLINE_ROWS = 10_000_000
COLS = 1024
DEGREE = 20
K = 100
LOG = {}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def _report(phase: str, **fields):
    LOG.setdefault(phase, {}).update(fields)
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def _precision(gold_idx, idx) -> float:
    return len(set(np.asarray(gold_idx).tolist())
               & set(np.asarray(idx).tolist())) / len(gold_idx)


def _gold(csr64, q):
    """Exact Top-K by the gold's rule (ops/gold.topk_of_scores) over
    float64 CSR products — the same scores as ops/gold.topk_exact, whose
    np.add.at form is too slow at 2e8 nnz."""
    from spmv_topk.ops.gold import topk_of_scores

    return topk_of_scores((csr64 @ q.astype(np.float64)).astype(np.float32),
                          K)


def _corpus(rows: int):
    from spmv_topk.formats import create_sparse_matrix

    t0 = time.perf_counter()
    coo = create_sparse_matrix(rows, COLS, DEGREE, "gamma", seed=1)
    return coo, time.perf_counter() - t0


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {f: int(getattr(m, f)) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, f)}


def _stream_bytes(eng) -> int:
    """Bytes one sweep must read: the packed words and the lane mask."""
    return eng.hbm_bytes + int(eng._valid.size)


# ---------------------------------------------------------------- main


def phase_main(rows: int, state: dict):
    import jax

    from spmv_topk import TopKSpMV, TopKSpMVConfig
    from spmv_topk.formats import create_query_batch
    from spmv_topk.ops.sweep import topk_query
    from spmv_topk.ops.xla_ref import sell_scores_np
    from spmv_topk.utils import native

    coo, gen_s = _corpus(rows)
    state["coo"] = coo
    csr64 = coo.to_scipy_csr().astype(np.float64)
    state["csr64"] = csr64
    _report("main", rows=rows, cols=COLS, nnz=int(coo.nnz),
            corpus_seconds=gen_s, native_runtime=native.available())

    cfg = TopKSpMVConfig(k=K, lane_k=8, max_cols=COLS, query_codec="h16",
                         width_quantum=2, rescore_pool=400)
    t0 = time.perf_counter()
    eng = TopKSpMV(coo, cfg)
    jax.block_until_ready(eng._words)
    setup_s = time.perf_counter() - t0
    state["h16"] = eng

    x = np.asarray(create_query_batch(1, COLS, seed=2)[0])
    t0 = time.perf_counter()
    compiled = topk_query.lower(
        eng._words, eng._valid, eng._row_ids, x, codec=cfg.query_codec,
        lane_k=cfg.lane_k, k=cfg.rescore_pool).compile()
    compile_s = time.perf_counter() - t0
    _report("main", h16_setup_seconds=setup_s,
            h16_compile_seconds=compile_s, buckets=len(eng.sell.buckets),
            h16_bytes_per_nnz=eng.bytes_per_nnz,
            h16_memory_analysis=_memory(compiled))

    queries = create_query_batch(8 + 32, COLS, seed=3)
    precisions, max_err, times = [], 0.0, []
    for q in queries[:8]:
        t0 = time.perf_counter()
        idx, vals = map(np.asarray, eng.query(q))
        times.append(time.perf_counter() - t0)
        gi, gv = _gold(csr64, q)
        precisions.append(_precision(gi, idx))
        max_err = max(max_err, float(np.abs(np.sort(vals)
                                            - np.sort(gv)).max()))
    bi, bv = map(np.asarray, eng.query_batch(queries[8:], group_size=32))
    t0 = time.perf_counter()  # second call: the first one compiles
    np.asarray(eng.query_batch(queries[8:], group_size=32)[1])
    batch_s = time.perf_counter() - t0
    for i, q in enumerate(queries[8:]):
        gi, gv = _gold(csr64, q)
        precisions.append(_precision(gi, bi[i]))
        max_err = max(max_err, float(np.abs(np.sort(bv[i])
                                            - np.sort(gv)).max()))
    # back to back, split into the device step (dispatch, sweep, merge to
    # the pool, readback) and the host rescore
    dev_t, host_t = [], []
    for q in queries[:8]:
        t0 = time.perf_counter()
        pool_idx = np.asarray(eng._topk(q, cfg.rescore_pool)[0])
        t1 = time.perf_counter()
        eng._rescore(pool_idx, q, K)
        dev_t.append(t1 - t0)
        host_t.append(time.perf_counter() - t1)
    prec = float(np.mean(precisions))
    _report("main", h16_query_device_step_ms=[t * 1e3 for t in dev_t],
            h16_query_rescore_ms=[t * 1e3 for t in host_t])
    _report("main", h16_precision_at_100=prec,
            h16_min_precision=float(np.min(precisions)),
            h16_max_abs_value_error=max_err,
            h16_query_e2e_ms=[t * 1e3 for t in times],  # first compiles
            h16_batch32_e2e_ms_per_query=batch_s * 1e3 / 32)
    assert prec >= 0.99, f"h16 + rescore precision@100 {prec} < 0.99"
    assert max_err <= 1e-5, f"h16 + rescore values off by {max_err}"

    f32 = TopKSpMV(coo, TopKSpMVConfig(k=K, lane_k=8, max_cols=COLS,
                                       query_codec="f32", width_quantum=2))
    state["f32"] = f32
    score_err, topk_err = 0.0, 0.0
    for q in queries[:2]:
        ref = sell_scores_np(f32.sell, q)
        score_err = max(score_err, float(np.abs(f32.scores(q) - ref).max()))
        idx, vals = map(np.asarray, f32.query(q))
        topk_err = max(topk_err, float(np.abs(vals - ref[idx]).max()))
    h16_ref = sell_scores_np(eng.sell, queries[0])
    h16_score_err = float(np.abs(eng.scores(queries[0]) - h16_ref).max())
    _report("main", f32_bytes_per_nnz=f32.bytes_per_nnz,
            f32_max_abs_score_error=score_err,
            f32_max_abs_topk_value_error=topk_err,
            h16_max_abs_score_error=h16_score_err)
    assert score_err <= 1e-5 and topk_err <= 1e-5, (score_err, topk_err)
    assert h16_score_err <= 1e-5, h16_score_err


# ------------------------------------------------------------- measure


def _copy_gbps(nbytes: int) -> float:
    """Read+write rate of a plain XLA elementwise pass over nbytes."""
    import jax
    import jax.numpy as jnp

    from spmv_topk.utils.profiling import timed_slope

    buf = jnp.zeros(nbytes // 4, jnp.int32)

    @jax.jit
    def run(b, n):
        return jax.lax.fori_loop(0, n, lambda i, b: b + 1, b)

    secs = timed_slope(lambda n: np.asarray(run(buf, n)[:1]), 2, 12)
    return 2 * nbytes / secs / 1e9


def phase_measure(state: dict):
    import jax

    from spmv_topk.bench import device_step_seconds
    from spmv_topk.bench.plots import hbm_peak_gbps

    eng = state["h16"]
    peak = hbm_peak_gbps(jax.devices()[0].device_kind)
    nbytes = _stream_bytes(eng)
    single = device_step_seconds(eng)
    group = device_step_seconds(eng, 32)
    copy = _copy_gbps(1 << 31)
    shares = {
        "single_query_ms": single * 1e3,
        "single_query_roofline_share": nbytes / single / 1e9 / peak,
        "batch32_ms_per_group": group * 1e3,
        "batch32_ms_per_query": group * 1e3 / 32,
        "batch32_roofline_share": nbytes / group / 1e9 / peak,
        "stream_bytes": nbytes, "hbm_peak_gbps": peak,
        "copy_gbps": copy,
    }
    _report("measure", **shares)


# --------------------------------------------------------------- dense


def phase_dense():
    import jax
    import jax.numpy as jnp

    from spmv_topk import DenseTopKSpMV, TopKSpMVConfig
    from spmv_topk.formats import create_query_batch
    from spmv_topk.ops.dense import dense_topk_batch
    from spmv_topk.ops.fixedpoint import quantize_bf16

    coo, _ = _corpus(1_000_000)
    csr = coo.to_scipy_csr()
    csr64 = csr.astype(np.float64)
    qs = create_query_batch(64, COLS, seed=11)
    golds = [_gold(csr64, q) for q in qs]
    for dtype in ("bf16", "int8"):
        eng = DenseTopKSpMV(coo, TopKSpMVConfig(k=K, max_cols=COLS),
                            dtype=dtype)
        idx, vals = map(np.asarray, eng.query_batch(qs))
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.asarray(eng.query_batch(qs)[1])
            t.append(time.perf_counter() - t0)
        prec = float(np.mean([_precision(g[0], i)
                              for g, i in zip(golds, idx)]))
        out = {f"{dtype}_precision_at_100": prec,
               f"{dtype}_batch64_ms": min(t) * 1e3}
        if dtype == "bf16":
            # products of the same bf16 inputs — the matrix truncated to
            # bf16 as densify_bf16 stores it, the query rounded as the dot
            # casts it — summed on the host in float64; the device sums
            # in f32, so 1e-3 bounds its rounding at these magnitudes
            err = 0.0
            for q, i, v in zip(qs[:8], idx[:8], vals[:8]):
                rows_ = csr[i].toarray().astype(np.float32)
                a16 = (rows_.view(np.uint32)
                       & np.uint32(0xFFFF0000)).view(np.float32)
                ref = a16.astype(np.float64) @ quantize_bf16(q).astype(
                    np.float64)
                err = max(err, float(np.abs(ref - v).max()))
            out["bf16_max_abs_value_error"] = err
            assert err <= 1e-3, f"dense bf16 values off by {err}"

            # approx_max_k's share of the step: the same blocked sweep
            # with the per-block selection replaced by a max
            A = eng._A
            qd = jnp.asarray(qs).astype(jnp.bfloat16).T
            nb = A.shape[0] // eng.block_rows

            @jax.jit
            def matmul_only(A, qt):
                def step(c, b):
                    blk = jax.lax.dynamic_slice_in_dim(
                        A, b * eng.block_rows, eng.block_rows, 0)
                    s = jnp.dot(blk, qt, preferred_element_type=jnp.float32)
                    return jnp.maximum(c, s.max()), None
                return jax.lax.scan(step, -jnp.inf, jnp.arange(nb))[0]

            def full():
                return dense_topk_batch(A, jnp.asarray(qs), k=K,
                                        block_rows=eng.block_rows,
                                        recall_target=eng.recall_target)[1]

            tm, tf = [], []
            np.asarray(matmul_only(A, qd)), np.asarray(full())
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(matmul_only(A, qd))
                tm.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                np.asarray(full())
                tf.append(time.perf_counter() - t0)
            out["bf16_approx_max_k_share"] = 1 - min(tm) / min(tf)
        _report("dense", **out)
        assert prec >= 0.95, f"dense {dtype} precision@100 {prec} < 0.95"
        del eng


# --------------------------------------------------------------- tests


def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    _report("tests", pytest_exit_code=int(rc))
    assert rc == 0, f"gpu tests failed (pytest exit code {rc})"


# --------------------------------------------------------------- multi


def phase_multi(rows: int):
    import jax

    from spmv_topk import DenseTopKSpMV, TopKSpMV, TopKSpMVConfig
    from spmv_topk.formats import create_query_batch
    from spmv_topk.parallel import (ShardedBucketedTopKSpMV,
                                    ShardedDenseTopKSpMV, make_mesh)

    devices = jax.devices()
    assert len(devices) == 4, f"--multi needs 4 GPUs, found {len(devices)}"
    coo, gen_s = _corpus(rows)
    csr64 = coo.to_scipy_csr().astype(np.float64)
    mesh = make_mesh(devices)
    queries = create_query_batch(8 + 32, COLS, seed=3)
    golds = [_gold(csr64, q) for q in queries]
    _report("multi", rows=rows, nnz=int(coo.nnz), corpus_seconds=gen_s)

    cfg = TopKSpMVConfig(k=K, lane_k=8, max_cols=COLS, query_codec="h16",
                         width_quantum=2, rescore_pool=400)
    t0 = time.perf_counter()
    sharded = ShardedBucketedTopKSpMV(coo, cfg, mesh=mesh)
    sharded_setup = time.perf_counter() - t0
    single = TopKSpMV(coo, cfg, device=devices[0])
    agree, prec, err = [], [], 0.0
    si = [np.asarray(sharded.query(q)[0]) for q in queries[:8]]
    di = [np.asarray(single.query(q)[0]) for q in queries[:8]]
    bi, bv = map(np.asarray, sharded.query_batch(queries[8:], group_size=32))
    dbi, _ = map(np.asarray, single.query_batch(queries[8:], group_size=32))
    s_all, d_all = si + list(bi), di + list(dbi)
    for (gi, gv), s, d in zip(golds, s_all, d_all):
        agree.append(_precision(d, s))
        prec.append(_precision(gi, s))
    for (gi, gv), v in zip(golds[8:], bv):
        err = max(err, float(np.abs(np.sort(v) - np.sort(gv)).max()))
    _report("multi", sparse_setup_seconds=sharded_setup,
            sparse_agreement_with_single=float(np.mean(agree)),
            sparse_precision_at_100=float(np.mean(prec)),
            sparse_max_abs_value_error=err)
    assert np.mean(agree) >= 0.99 and np.mean(prec) >= 0.99, (agree, prec)
    assert err <= 1e-5, err
    del sharded, single

    dcfg = TopKSpMVConfig(k=K, max_cols=COLS)
    qs = queries[8:]
    sd = ShardedDenseTopKSpMV(coo, dcfg, mesh=mesh)
    sdi = np.asarray(sd.query_batch(qs)[0])
    del sd
    dd = DenseTopKSpMV(coo, dcfg, device=devices[0])
    ddi = np.asarray(dd.query_batch(qs)[0])
    del dd
    d_agree = float(np.mean([_precision(a, b) for a, b in zip(ddi, sdi)]))
    d_prec = float(np.mean([_precision(g[0], s)
                            for g, s in zip(golds[8:], sdi)]))
    _report("multi", dense_agreement_with_single=d_agree,
            dense_precision_at_100=d_prec)
    assert d_agree >= 0.95 and d_prec >= 0.95, (d_agree, d_prec)


# ---------------------------------------------------------------- run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run only the sharded engines")
    ap.add_argument("--rows", type=int, default=HEADLINE_ROWS,
                    help="cut the headline corpus to this many rows")
    args = ap.parse_args(argv)

    try:
        print(_card(), flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nvidia-smi failed: {e!r}", file=sys.stderr)
        return 2
    import jax

    from spmv_topk.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)
    if dev.platform != "gpu":
        print("chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform}", file=sys.stderr)
        return 2
    if args.rows != HEADLINE_ROWS:
        print(f"corpus cut: {args.rows} rows instead of {HEADLINE_ROWS} "
              "(width unchanged)", flush=True)

    state: dict = {}
    phases = ([("multi", lambda: phase_multi(args.rows))] if args.multi
              else [("main", lambda: phase_main(args.rows, state)),
                    ("measure", lambda: phase_measure(state)),
                    ("dense", phase_dense),
                    ("tests", phase_tests)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase must not hide the others
            traceback.print_exc()
            failed.append(name)
        _report(name, seconds=time.perf_counter() - t0,
                ok=name not in failed)
        if name == "main" and failed:
            break  # the later phases need the main phase's engines
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"device": device, "failed": failed, **LOG}, fh,
                  indent=1, default=str)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
