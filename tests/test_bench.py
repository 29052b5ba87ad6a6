"""Benchmark harness smoke tests (CSV protocol, warm-up statistics)."""

import numpy as np

from spmv_topk.api import TopKSpMV
from spmv_topk.bench import run_benchmark, CSV_HEADER
from spmv_topk.config import TopKSpMVConfig
from spmv_topk.formats import create_sparse_matrix


def test_harness_csv_and_stats():
    coo = create_sparse_matrix(800, 256, 10, "uniform", seed=40)
    cfg = TopKSpMVConfig(k=10, max_cols=256)
    eng = TopKSpMV(coo, cfg)
    res = run_benchmark(eng, coo, num_tests=4, k=10, seed=41)
    lines = res.csv.strip().split("\n")
    assert lines[0] == CSV_HEADER
    assert len(lines) == 5
    assert res.mean_precision == 1.0
    assert res.mean_exec_ms > 0
    assert np.isfinite(res.nnz_per_sec)


def test_cli_h16_rescore(tmp_path, capsys):
    """CLI: the production h16 codec with an exact rescore pool runs the
    benchmark loop end to end and writes the CSV."""
    from spmv_topk.cli import main

    csv = tmp_path / "out.csv"
    rc = main(["--synthetic", "1500", "256", "8", "gamma",
               "-k", "20", "-t", "2", "--codec", "h16",
               "--rescore-pool", "80", "--csv", str(csv)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "precision" in out and csv.read_text().count("\n") >= 2
    # precision printed at the end must be ~exact (rescore pool)
    prec = float(out.split("precision")[1].split(";")[0])
    assert prec >= 0.95


def test_device_step_seconds_single_and_group():
    """The scan-slope timer used by bench.py and chip_smoke.py runs both
    step shapes (one query, one group) and returns a finite time."""
    from spmv_topk.bench import device_step_seconds

    coo = create_sparse_matrix(1000, 256, 8, "uniform", seed=42)
    eng = TopKSpMV(coo, TopKSpMVConfig(k=10, max_cols=256,
                                       query_codec="h16", rescore_pool=40))
    for group in (0, 4):
        secs = device_step_seconds(eng, group)
        assert np.isfinite(secs)
